"""Russian number-to-text conversion for FT numbers search.

Mirrors cpp_src/core/ft/numtotext.cc: a digit string converts to the list
of Russian words spelling it (e.g. "125" -> ["сто", "двадцать", "пять"]).
With enable_numbers_search the index build adds these as "virtual words"
at the numeric token's position (dataprocessor.cc:274-277, 325-345), so a
text query in Russian finds documents containing the digits.

Leading zeros each emit "ноль"; digit strings longer than 27 after zero
stripping convert to nothing (numtotext.cc:86-95 "unreasonably big").
"""
from __future__ import annotations

UNITS = ("", "один", "два", "три", "четыре", "пять", "шесть", "семь",
         "восемь", "девять")
UNITS_NOMINAT = ("", "одна", "две", "три", "четыре", "пять", "шесть",
                 "семь", "восемь", "девять")
TENS = ("", "одиннадцать", "двенадцать", "тринадцать", "четырнадцать",
        "пятнадцать", "шестнадцать", "семнадцать", "восемнадцать",
        "девятнадцать")
DECADES = ("", "десять", "двадцать", "тридцать", "сорок", "пятьдесят",
           "шестьдесят", "семьдесят", "восемьдесят", "девяносто")
HUNDREDS = ("", "сто", "двести", "триста", "четыреста", "пятьсот",
            "шестьсот", "семьсот", "восемьсот", "девятьсот")

# per-order plural forms indexed by the group's unit digit
# (numtotext.cc kNumOrders); row 0 = thousands, row 7 = septillions
_ORDER_STEMS = (
    ("тысяч", "тысяча", "тысячи", "тысячи", "тысячи", "тысяч", "тысяч",
     "тысяч", "тысяч", "тысяч"),
    ("миллионов", "миллион", "миллиона", "миллиона", "миллиона",
     "миллионов", "миллионов", "миллионов", "миллионов", "миллионов"),
    ("миллиардов", "миллиард", "миллиарда", "миллиарда", "миллиарда",
     "миллиардов", "миллиардов", "миллиардов", "миллиардов", "миллиардов"),
    ("триллионов", "триллион", "триллиона", "триллиона", "триллиона",
     "триллионов", "триллионов", "триллионов", "триллионов", "триллионов"),
    ("квадриллионов", "квадриллион", "квадриллиона", "квадриллиона",
     "квадриллиона", "квадриллионов", "квадриллионов", "квадриллионов",
     "квадриллионов", "квадриллионов"),
    ("квинтиллионов", "квинтиллион", "квинтиллиона", "квинтиллиона",
     "квинтиллиона", "квинтиллионов", "квинтиллионов", "квинтиллионов",
     "квинтиллионов", "квинтиллионов"),
    ("секстиллионов", "секстиллион", "секстиллиона", "секстиллиона",
     "секстиллиона", "секстиллионов", "секстиллионов", "секстиллионов",
     "секстиллионов", "секстиллионов"),
    ("септиллионов", "септиллион", "септиллиона", "септиллиона",
     "септиллиона", "септиллионов", "септиллионов", "септиллионов",
     "септиллионов", "септиллионов"),
)


def is_number(s: str) -> bool:
    """True for non-empty all-ASCII-digit strings (stringstools is_number)."""
    return bool(s) and all("0" <= c <= "9" for c in s)


def num_to_text(num_str: str) -> list[str]:
    """Digit string -> Russian words (numtotext.cc NumToText::convert)."""
    out: list[str] = []
    k = 0
    while k < len(num_str) and num_str[k] == "0":
        out.append("ноль")
        k += 1
    s = num_str[k:]
    if len(s) > 27:          # unreasonably big
        return []
    if not s:
        return out
    orders_max = (len(s) - 1) // 3 + 1
    order_digits = len(s) - (orders_max - 1) * 3
    off = 0
    for k in range(orders_max, 0, -1):
        hund = ten = num = 0
        if order_digits == 1:
            num = int(s[off])
        elif order_digits == 2:
            ten, num = int(s[off]), int(s[off + 1])
        else:
            hund, ten, num = int(s[off]), int(s[off + 1]), int(s[off + 2])
        if hund:
            out.append(HUNDREDS[hund])
        if ten == 1 and num != 0:
            out.append(TENS[num])
        elif ten != 0:
            out.append(DECADES[ten])
        if num != 0 and ten != 1:
            out.append(UNITS_NOMINAT[num] if k == 2 else UNITS[num])
        if k > 1 and (hund or ten or num):
            out.append(_ORDER_STEMS[k - 2][num])
        off += order_digits
        order_digits = 3
    return out
