"""Port of reindexer_tpu/server/auth.py: a copy of the reference's module
(host only; the same wire format).

The reference's notes follow.

Role-based authentication for the server.

Semantic equivalent of the reference DBManager auth
(cpp_src/server/dbmanager.cc + authmanager.cc: users with role per database;
roles data_read < data_write < db_admin < owner; HTTP basic auth). Passwords
are stored as salted SHA-256 (`sha256:<salt>:<hex>`) or plain (test only) —
the reference supports md5crypt variants similarly.
"""
from __future__ import annotations

import base64
import hashlib
import secrets
from typing import Optional

ROLE_ORDER = {"none": 0, "data_read": 1, "data_write": 2,
              "db_admin": 3, "owner": 4}


def hash_password(password: str, salt: Optional[str] = None) -> str:
    salt = salt or secrets.token_hex(8)
    digest = hashlib.sha256((salt + password).encode()).hexdigest()
    return f"sha256:{salt}:{digest}"


_MD5CRYPT_B64 = "./0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"


def md5crypt(password: str, salt: str, magic: str = "$1$") -> str:
    """FreeBSD md5crypt ($1$salt$hash) — the reference's stored-password
    scheme when built with openssl (dbmanager.cc ENABLE_OPENSSL,
    tools/md5crypt.cc). Pure-python port of the published algorithm."""
    pw = password.encode()
    sl = salt.encode()[:8]
    m = hashlib.md5(pw + magic.encode() + sl)
    mixin = hashlib.md5(pw + sl + pw).digest()
    for i in range(len(pw)):
        m.update(bytes([mixin[i % 16]]))
    i = len(pw)
    while i:
        m.update(b"\0" if i & 1 else pw[:1])
        i >>= 1
    final = m.digest()
    for i in range(1000):
        m2 = hashlib.md5()
        m2.update(pw if i & 1 else final)
        if i % 3:
            m2.update(sl)
        if i % 7:
            m2.update(pw)
        m2.update(final if i & 1 else pw)
        final = m2.digest()
    out = []
    for a, b, c in ((0, 6, 12), (1, 7, 13), (2, 8, 14), (3, 9, 15),
                    (4, 10, 5)):
        v = (final[a] << 16) | (final[b] << 8) | final[c]
        for _ in range(4):
            out.append(_MD5CRYPT_B64[v & 0x3F])
            v >>= 6
    v = final[11]
    out.append(_MD5CRYPT_B64[v & 0x3F])
    out.append(_MD5CRYPT_B64[(v >> 6) & 0x3F])
    return magic + sl.decode() + "$" + "".join(out)


def check_password(stored: str, password: str) -> bool:
    if stored.startswith("sha256:"):
        _, salt, digest = stored.split(":", 2)
        return hashlib.sha256(
            (salt + password).encode()).hexdigest() == digest
    if stored.startswith("$1$"):            # md5crypt (reference parity)
        parts = stored.split("$")
        if len(parts) >= 4:
            return secrets.compare_digest(
                md5crypt(password, parts[2]), stored)
        return False
    return secrets.compare_digest(stored, password)


class AuthManager:
    """users: {name: {"hash": ..., "roles": {db_name|"*": role}}}"""

    def __init__(self, users: Optional[dict] = None):
        self.users = users or {}

    @property
    def enabled(self) -> bool:
        return bool(self.users)

    def add_user(self, name: str, password: str,
                 roles: Optional[dict] = None) -> None:
        self.users[name] = {"hash": hash_password(password),
                            "roles": roles or {"*": "owner"}}

    def authenticate(self, authorization: Optional[str]) -> Optional[str]:
        """Returns the user name for a Basic auth header, or None."""
        if not authorization or not authorization.startswith("Basic "):
            return None
        try:
            raw = base64.b64decode(authorization[6:]).decode()
            name, _, password = raw.partition(":")
        except Exception:
            return None
        user = self.users.get(name)
        if user is None or not check_password(user["hash"], password):
            return None
        return name

    def role_for(self, user: Optional[str], db_name: str) -> str:
        if user is None:
            return "none"
        roles = self.users.get(user, {}).get("roles", {})
        return roles.get(db_name, roles.get("*", "none"))

    def allows(self, user: Optional[str], db_name: str, need: str) -> bool:
        return ROLE_ORDER[self.role_for(user, db_name)] >= ROLE_ORDER[need]
