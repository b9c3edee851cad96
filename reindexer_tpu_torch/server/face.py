"""Port of reindexer_tpu/server/face.py: a copy of the reference's module
(host only; the same wire format).

The reference's notes follow.

Minimal bundled admin UI (the analog of the reference's web face,
cpp_src/server/resources_wrapper.cc + the /face routes,
httpserver.cc:1060,1101-1104): a single self-contained HTML page served at
/face that drives the REST API from the browser — database/namespace
explorer, item/index inspection, a SQL console, and live #memstats /
#perfstats views. No build step, no external assets."""

FACE_HTML = """<!DOCTYPE html>
<html lang="en">
<head>
<meta charset="utf-8">
<title>reindexer_tpu</title>
<style>
  :root { --bg:#11151a; --panel:#1a212a; --fg:#d7dde5; --dim:#7d8a99;
          --acc:#4aa3ff; --ok:#49c97a; --err:#ff6b6b; }
  * { box-sizing: border-box; }
  body { margin:0; background:var(--bg); color:var(--fg);
         font:14px/1.5 ui-monospace, SFMono-Regular, Menlo, monospace; }
  header { padding:10px 16px; background:var(--panel);
           border-bottom:1px solid #2a3442; display:flex; gap:16px;
           align-items:center; }
  header b { color:var(--acc); }
  main { display:grid; grid-template-columns: 260px 1fr; gap:12px;
         padding:12px 16px; }
  .panel { background:var(--panel); border:1px solid #2a3442;
           border-radius:6px; padding:10px 12px; }
  h3 { margin:4px 0 8px; font-size:13px; color:var(--dim);
       text-transform:uppercase; letter-spacing:.08em; }
  ul { list-style:none; margin:0; padding:0; }
  li { padding:3px 6px; border-radius:4px; cursor:pointer; }
  li:hover, li.sel { background:#243040; color:var(--acc); }
  textarea { width:100%; height:70px; background:#0d1117; color:var(--fg);
             border:1px solid #2a3442; border-radius:4px; padding:8px;
             font:inherit; }
  button { background:var(--acc); color:#08121f; border:0; padding:6px 14px;
           border-radius:4px; font:inherit; cursor:pointer; }
  table { border-collapse:collapse; width:100%; margin-top:8px; }
  th, td { border:1px solid #2a3442; padding:4px 8px; text-align:left;
           font-size:13px; max-width:420px; overflow:hidden;
           text-overflow:ellipsis; white-space:nowrap; }
  th { color:var(--dim); }
  .err { color:var(--err); white-space:pre-wrap; }
  .meta { color:var(--dim); margin:6px 0; }
</style>
</head>
<body>
<header><b>reindexer_tpu</b>
  <span>db: <select id="dbs"></select></span>
  <span id="status" class="meta"></span>
</header>
<main>
  <div class="panel">
    <h3>Namespaces</h3><ul id="nss"></ul>
    <h3 style="margin-top:14px">System</h3><ul id="sys"></ul>
  </div>
  <div>
    <div class="panel">
      <h3>SQL console</h3>
      <textarea id="sql">SELECT * FROM #namespaces LIMIT 10</textarea>
      <div style="margin-top:6px"><button onclick="runSql()">Run</button>
        <span id="took" class="meta"></span></div>
    </div>
    <div class="panel" style="margin-top:12px">
      <h3 id="rtitle">Results</h3><div id="results"></div>
    </div>
  </div>
</main>
<script>
const $ = id => document.getElementById(id);
const api = p => `/api/v1/db/${$("dbs").value}${p}`;
const SYS = ["#memstats", "#perfstats", "#queriesperfstats", "#activitystats",
             "#clientsstats", "#replicationstats", "#config"];

async function j(url, opts) {
  const r = await fetch(url, opts);
  const body = await r.json().catch(() => ({}));
  if (!r.ok) throw new Error(body.description || r.statusText);
  return body;
}

function renderTable(items) {
  if (!items || !items.length) return "<div class=meta>0 rows</div>";
  const cols = [...new Set(items.flatMap(o => Object.keys(o)))];
  const esc = s => String(s).replace(/[&<>]/g,
      c => ({"&":"&amp;","<":"&lt;",">":"&gt;"}[c]));
  let h = "<table><tr>" + cols.map(c => `<th>${esc(c)}</th>`).join("")
        + "</tr>";
  for (const o of items.slice(0, 200)) {
    h += "<tr>" + cols.map(c => {
      let v = o[c];
      if (v === undefined) v = "";
      if (typeof v === "object") v = JSON.stringify(v);
      return `<td>${esc(v)}</td>`;
    }).join("") + "</tr>";
  }
  return h + "</table>" + (items.length > 200
      ? `<div class=meta>showing 200 of ${items.length}</div>` : "");
}

async function runSql(sql) {
  sql = sql || $("sql").value;
  $("rtitle").textContent = "Results";
  const t0 = performance.now();
  try {
    const res = await j(api("/query?q=" + encodeURIComponent(sql)));
    $("took").textContent =
        `${(performance.now() - t0).toFixed(1)} ms, ` +
        `${(res.items || []).length} rows`;
    $("results").innerHTML = renderTable(res.items);
  } catch (e) {
    $("results").innerHTML = `<div class=err>${e.message}</div>`;
  }
}

function select(listId, el) {
  document.querySelectorAll("li.sel").forEach(x => x.classList.remove("sel"));
  el.classList.add("sel");
}

async function loadNss() {
  const res = await j(api("/namespaces"));
  const names = (res.items || res.namespaces || [])
      .map(x => x.name || x).filter(n => !n.startsWith("#"));
  $("nss").innerHTML = "";
  for (const n of names) {
    const li = document.createElement("li");
    li.textContent = n;
    li.onclick = () => { select("nss", li); $("sql").value =
        `SELECT * FROM ${n} LIMIT 50`; runSql(); };
    $("nss").appendChild(li);
  }
  $("sys").innerHTML = "";
  for (const n of SYS) {
    const li = document.createElement("li");
    li.textContent = n;
    li.onclick = () => { select("sys", li); $("sql").value =
        `SELECT * FROM ${n}`; runSql(); };
    $("sys").appendChild(li);
  }
}

async function init() {
  try {
    const dbs = await j("/api/v1/db");
    const names = (dbs.items || []).map(x => x.name || x);
    $("dbs").innerHTML = names.map(n => `<option>${n}</option>`).join("");
    $("dbs").onchange = loadNss;
    $("status").textContent = `${names.length} database(s)`;
    if (names.length) await loadNss();
  } catch (e) {
    $("status").innerHTML = `<span class=err>${e.message}</span>`;
  }
}
init();
</script>
</body>
</html>
"""
