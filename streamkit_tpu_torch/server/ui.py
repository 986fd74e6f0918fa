# SPDX-License-Identifier: Apache-2.0
"""Built-in web UI.

``/`` and ``/ui`` serve the full dependency-free app
(``webui/index.html``: Design / Convert / Stream / Monitor views —
functional parity with the reference React app's core workflows,
``ui/src/views/``); ``/monitor`` keeps the original minimal live monitor.
"""

from __future__ import annotations

import os

from . import http as web

__all__ = ["add_ui_routes"]

_WEBUI = os.path.join(os.path.dirname(__file__), "webui", "index.html")

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>streamkit-tpu monitor</title>
<style>
 body { font: 13px/1.5 ui-monospace, monospace; margin: 0; background: #10141a; color: #d6dde6; }
 header { padding: 10px 16px; background: #161c24; border-bottom: 1px solid #26303c;
          display: flex; gap: 16px; align-items: baseline; }
 h1 { font-size: 14px; margin: 0; color: #7fd1b9; }
 main { display: grid; grid-template-columns: 330px 1fr; gap: 0; height: calc(100vh - 41px); }
 section { overflow: auto; padding: 12px 16px; }
 #sessions { border-right: 1px solid #26303c; }
 .sess { padding: 8px 10px; margin: 6px 0; background: #161c24; border-radius: 6px;
         cursor: pointer; border: 1px solid transparent; }
 .sess:hover, .sess.active { border-color: #7fd1b9; }
 .dim { color: #6b7785; } .ok { color: #7fd1b9; } .warn { color: #e7c46c; } .err { color: #e06c75; }
 pre { white-space: pre-wrap; word-break: break-all; margin: 2px 0; }
 .node { display: inline-block; background: #1d2530; border-radius: 4px; padding: 2px 8px;
         margin: 2px; border: 1px solid #26303c; }
 #events { max-height: 40vh; overflow: auto; border-top: 1px solid #26303c;
           padding-top: 8px; margin-top: 12px; }
</style></head><body>
<header><h1>streamkit-tpu</h1><span id="status" class="dim">connecting…</span></header>
<main>
 <section id="sessions"><h3 class="dim">sessions</h3><div id="slist"></div></section>
 <section>
   <h3 class="dim">pipeline</h3><div id="pipeline" class="dim">select a session</div>
   <h3 class="dim">events</h3><div id="events"></div>
 </section>
</main>
<script>
const base = location.pathname.replace(/\\/$/, "");
let current = null;
async function refresh() {
  const r = await fetch(`${base}/api/v1/sessions`);
  const { sessions } = await r.json();
  const el = document.getElementById("slist");
  el.innerHTML = "";
  for (const s of sessions) {
    const d = document.createElement("div");
    d.className = "sess" + (s.id === current ? " active" : "");
    d.innerHTML = `<b>${s.name || "(unnamed)"}</b><br><span class="dim">${s.id}</span>`;
    d.onclick = () => { current = s.id; showPipeline(s.id); refresh(); };
    el.appendChild(d);
  }
  if (!sessions.length) el.innerHTML = '<span class="dim">none</span>';
}
async function showPipeline(id) {
  const r = await fetch(`${base}/api/v1/sessions/${id}/pipeline`);
  const { pipeline } = await r.json();
  const el = document.getElementById("pipeline");
  el.innerHTML = "";
  for (const [name, n] of Object.entries(pipeline.nodes)) {
    const state = typeof n.state === "string" ? n.state : Object.keys(n.state || {})[0];
    const cls = state === "running" ? "ok" : state === "failed" ? "err" : "warn";
    el.innerHTML += `<span class="node">${name} <span class="dim">${n.kind}</span> <span class="${cls}">${state||""}</span></span>`;
  }
  el.innerHTML += "<pre class='dim'>" +
    pipeline.connections.map(c => `${c.from_node}:${c.from_pin} → ${c.to_node}:${c.to_pin}`).join("\\n") + "</pre>";
}
function connectWs() {
  const ws = new WebSocket(`${location.protocol === "https:" ? "wss" : "ws"}://${location.host}${base}/api/v1/control`);
  const status = document.getElementById("status");
  ws.onopen = () => { status.textContent = "live"; status.className = "ok"; refresh(); };
  ws.onclose = () => { status.textContent = "disconnected — retrying"; status.className = "err";
                       setTimeout(connectWs, 2000); };
  ws.onmessage = (m) => {
    const msg = JSON.parse(m.data);
    if (msg.type !== "event") return;
    const ev = msg.payload;
    const el = document.getElementById("events");
    const line = document.createElement("pre");
    line.textContent = `${ev.event}  ${JSON.stringify(ev).slice(0, 300)}`;
    el.prepend(line);
    while (el.children.length > 200) el.removeChild(el.lastChild);
    if (["sessioncreated", "sessiondestroyed"].includes(ev.event)) refresh();
    if (ev.session_id === current && ["nodestatechanged","nodeadded","noderemoved"].includes(ev.event))
      showPipeline(current);
  };
}
connectWs();
setInterval(refresh, 5000);
</script></body></html>
"""


async def index(request: web.Request) -> web.StreamResponse:
    if os.path.exists(_WEBUI):
        return web.FileResponse(_WEBUI)
    return web.Response(text=_PAGE, content_type="text/html")


async def monitor(request: web.Request) -> web.Response:
    return web.Response(text=_PAGE, content_type="text/html")


def add_ui_routes(app: web.Application, prefix: str) -> None:
    app.router.add_get(prefix + "/", index)
    app.router.add_get(prefix + "/ui", index)
    app.router.add_get(prefix + "/ui/", index)
    app.router.add_get(prefix + "/monitor", monitor)
    if prefix:
        app.router.add_get(prefix, index)
