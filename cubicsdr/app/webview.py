"""Headless web UI: live waterfall/spectrum viewer + tuning REST API.

The headless replacement for the reference's wxWidgets/OpenGL frontend
(ref: src/AppFrame.{h,cpp}, src/visual/WaterfallCanvas.cpp,
src/panel/WaterfallPanel.cpp): the framework emits display-ready arrays
(normalized spectrum points, palette-mapped waterfall rows), and this module
serves them over plain HTTP from the stdlib server — no GUI toolkit, no GL.

Endpoints
  GET  /                   single-page viewer (embedded HTML/JS canvas)
  GET  /api/state          receiver state: center/rate/demods/metrics
  GET  /api/spectrum       latest spectrum points + floor/ceil (JSON)
  GET  /api/waterfall.png  current waterfall image
  POST /api/control        {"action": ...} commands, mirroring the
                           reference's hotkey/mouse surface
                           (ref: AppFrame::OnGlobalKeyDown,
                           src/AppFrame.cpp:2812-3087):
      tune       {freq}                   retune center frequency
      add        {freq, type, bandwidth}  create a demodulator
      remove     {index}
      set        {index, key, value}      frequency/bandwidth/squelch_level/
                                          squelch_enabled/gain/mute/solo/
                                          active/label
      theme      {name}                   waterfall palette
      view       {index|null}             select the demod-view spectrum
                                          target (GET /api/demod_spectrum)
      zoom       {offset, bandwidth}      zoomed main-spectrum view
                                          (continuity-preserving)
  GET/POST /api/bookmarks  bookmark groups/recents/ranges + CRUD ops
                           (ref: src/forms/Bookmark/BookmarkView.cpp)
  GET/POST /api/gains      per-stage gain sliders backed by DeviceConfig,
                           forwarded to a live source
                           (ref: src/visual/GainCanvas.cpp)
  GET  /api/devices        device enumeration
                           (ref: src/forms/SDRDevices/SDRDevices.cpp)

Control changes rebuild the pipeline's traced control vectors (retunes and
squelch/gain/mute are jit INPUTS, so no recompile); add/remove of demods
changes the compiled plan and is applied between blocks, the moral
equivalent of the reference's async DemodulatorWorkerThread kit swap
(ref: src/demod/DemodulatorWorkerThread.cpp:54-109).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

_PAGE = """<!doctype html>
<html><head><meta charset="utf-8"><title>cubicsdr</title>
<style>
 body { background:#111; color:#ddd; font:13px monospace; margin:12px; }
 canvas { display:block; background:#000; margin-bottom:6px; }
 #demods div { padding:2px 4px; cursor:pointer; }
 #demods div.sel { background:#234; }
 input { background:#222; color:#ddd; border:1px solid #555; }
 button { background:#333; color:#ddd; border:1px solid #555; }
</style></head><body>
<div id="hdr"></div>
<canvas id="spec" width="1024" height="160"></canvas>
<canvas id="wf" width="1024" height="320"></canvas>
<canvas id="zoom" width="1024" height="120" style="display:none"></canvas>
<div>center <input id="freq" size="12"> <button onclick="tune()">tune</button>
 <button onclick="nudge(-25000)">-25k</button>
 <button onclick="nudge(25000)">+25k</button>
 <button onclick="addDemod()">add demod @ click</button>
 <button onclick="zoomAt()">zoom @ click</button>
 <button onclick="ctl({action:'zoom', offset:null}).then(
   () => document.getElementById('zoom').style.display = 'none')">unzoom</button>
 theme <select id="theme" onchange="setTheme()"></select>
 <button onclick="listen()">listen</button>
 <button onclick="bookmarkSel()">bookmark</button></div>
<div>device <select id="devsel"></select>
 <button onclick="devSelect()">switch</button>
 <button onclick="devCtl('stop')">stop</button>
 <button onclick="devCtl('start')">start</button>
 | lps <input id="lps" size="3" onchange="setDisplay()">
 avg <input id="avg" size="4" onchange="setDisplay()">
 peak <input id="peak" type="checkbox" onchange="setDisplay()">
 snap <input id="snap" size="6" onchange="setSnap()">
 ppm ref <input id="ppmref" size="10" placeholder="Hz">
 <button onclick="ppmMeasure()">measure</button>
 <span id="ppmout"></span>
 perf <select id="perf" onchange="setPerf()">
  <option>low</option><option>normal</option><option>high</option>
 </select></div>
<audio id="aud" controls style="display:none"></audio>
<div id="demods"></div>
<div id="gains"></div>
<div id="bookmarks"></div>
<pre id="console"></pre>
<script>
let st = null, clickFreq = null;
const wf = document.getElementById('wf'), spec = document.getElementById('spec');
async function poll() {
  try {
    st = await (await fetch('/api/state')).json();
    document.getElementById('hdr').textContent =
      `center ${st.center_freq} Hz  rate ${st.sample_rate}  ` +
      `blocks ${st.metrics.blocks||0}  ${st.metrics.samples_per_s||0} S/s`;
    const sel = document.getElementById('theme');
    if (!sel.options.length) for (const t of st.themes) {
      const o = document.createElement('option'); o.value = o.text = t;
      sel.add(o); }
    sel.value = st.theme;
    const dd = document.getElementById('demods');
    dd.innerHTML = '';
    st.demods.forEach((d, i) => {
      const e = document.createElement('div');
      if (i === selIdx) e.className = 'sel';
      e.draggable = true;     // drag a demod onto a bookmark group
      e.ondragstart = ev => ev.dataTransfer.setData('text/plain',
        JSON.stringify({kind:'demod', i:i}));
      const lbl = document.createElement('span');
      lbl.textContent = `#${i} ${d.type} ${d.frequency} Hz ` +
        `bw=${d.bandwidth} sq=${d.squelch_enabled?d.squelch_level:'off'}` +
        ` ${d.muted?'MUTE':''} level=${(d.level||0).toFixed(1)} dB `;
      lbl.onclick = () => { selIdx = i; };
      e.appendChild(lbl);
      // Per-demod runtime controls: record attach/detach ('R' hotkey,
      // ref: DemodulatorInstance startRecording), solo-to-host-audio,
      // and the generated modem-settings panel (ref: ModemProperties).
      for (const [txt, fn] of [
        [d.recording ? '■rec' : '●rec',
         () => ctl({action:'set', index:i, key:'recording',
                    value:!d.recording})],
        ['solo', () => { soloIdx = (soloIdx === i) ? null : i;
                         ctl({action:'audio_solo', index: soloIdx}); }],
        ['set..', () => editSettings(i)],
        ['view', () => ctl({action:'view', index:i})],
        ['x', () => ctl({action:'remove', index:i})]]) {
        const b = document.createElement('button');
        b.textContent = txt; b.onclick = fn; e.appendChild(b);
      }
      dd.appendChild(e);
    });
    const sp = await (await fetch('/api/spectrum')).json();
    drawSpec(document.getElementById('spec'), sp.points);
    if (sp.zoom && sp.zoom.points.length) {
      const z = document.getElementById('zoom');
      z.style.display = 'block';
      drawSpec(z, sp.zoom.points, '#fc6');
    }
    const g = await (await fetch('/api/gains')).json();
    document.getElementById('gains').innerHTML = g.stages.map(s =>
      `${s.name} <input type="range" min="${s.min}" max="${s.max}"` +
      ` value="${s.value}" onchange="setGain('${s.name}',this.value)">` +
      ` ${s.value.toFixed(1)} dB`).join(' | ') +
      (g.stages.length ? ` | AGC <input type="checkbox"` +
       ` ${g.agc?'checked':''} onchange="setAgc(this.checked)">` : '');
    const bm = await (await fetch('/api/bookmarks')).json();
    // Drag-drop organization (the BookmarkView tree's primary
    // interaction, ref: src/forms/Bookmark/BookmarkView.cpp): drag an
    // entry onto another group's header to MOVE it, onto another entry
    // in the same group to REORDER, or drag a demod row here to file it.
    document.getElementById('bookmarks').innerHTML =
      Object.entries(bm.groups).map(([grp, es]) =>
        `<b class="bmg" data-g="${grp}" ondragover="event.preventDefault()"` +
        ` ondrop="bmDrop(event,'${grp}',null)">${grp}</b>: ` +
        es.map((e, i) =>
          `<a href="#" draggable="true" class="bme"` +
          ` ondragstart="bmDrag(event,'${grp}',${i})"` +
          ` ondragover="event.preventDefault()"` +
          ` ondrop="bmDrop(event,'${grp}',${i})"` +
          ` onclick="bmGo('${grp}',${i});return false">` +
          `${e.demod_type}@${e.frequency}</a>`).join(' ')).join('  ');
    const img = new Image();
    img.onload = () => wf.getContext('2d')
        .drawImage(img, 0, 0, wf.width, wf.height);
    img.src = '/api/waterfall.png?' + Date.now();
  } catch (e) {}
  setTimeout(poll, 300);
}
function drawSpec(cv, pts, color) {
  const c = cv.getContext('2d'); c.clearRect(0,0,cv.width,cv.height);
  c.strokeStyle = color || '#6cf'; c.beginPath();
  pts.forEach((p, i) => {
    const x = i / pts.length * cv.width, y = (1 - p) * cv.height;
    i ? c.lineTo(x, y) : c.moveTo(x, y); });
  c.stroke();
}
async function ctl(body) {
  return fetch('/api/control', {method:'POST', body: JSON.stringify(body)});
}
/* Generated modem-settings editor (ref: src/ModemProperties.cpp): pull
   the typed schema, prompt per arg, POST the edits (plan rebuilds with
   state carry server-side). */
async function editSettings(i) {
  const sch = await (await fetch('/api/modem_settings?index=' + i)).json();
  if (!sch.ok || !sch.schema.length) {
    alert(sch.type + ': no editable settings'); return;
  }
  const edits = {};
  for (const a of sch.schema) {
    const cur = sch.settings[a.key] !== undefined ? sch.settings[a.key]
                                                  : a.value;
    const hint = a.options ? ` (${a.options.join('/')})`
               : a.low !== null ? ` [${a.low}..${a.high}]` : '';
    const v = prompt(`${sch.type} ${a.name}${hint}:`, cur);
    if (v === null) continue;
    edits[a.key] = a.type === 'string' ? v : parseFloat(v);
  }
  if (Object.keys(edits).length)
    await ctl({action:'modem_settings', index:i, settings:edits});
}
/* Global hotkeys (ref: AppFrame::OnGlobalKeyDown, src/AppFrame.cpp:
   2812-3087): arrows tune the center, brackets step the SELECTED demod's
   bandwidth, m/r/s/v act on the selected demod, space focuses the
   frequency entry. Click a demod row to select it. */
let selIdx = 0, soloIdx = null;
document.addEventListener('keydown', (ev) => {
  if (ev.target.tagName === 'INPUT' || ev.target.tagName === 'SELECT'
      || !st) return;
  const d = st.demods[selIdx];
  const acts = {
    'ArrowLeft':  () => nudge(-25000),
    'ArrowRight': () => nudge(25000),
    'ArrowDown':  () => nudge(-250000),
    'ArrowUp':    () => nudge(250000),
    '[': () => d && ctl({action:'set', index:selIdx, key:'bandwidth',
                         value: Math.max(d.bandwidth * 0.9, 5000)}),
    ']': () => d && ctl({action:'set', index:selIdx, key:'bandwidth',
                         value: d.bandwidth * 1.1}),
    'm': () => d && ctl({action:'set', index:selIdx, key:'mute',
                         value:!d.muted}),
    'r': () => d && ctl({action:'set', index:selIdx, key:'recording',
                         value:!d.recording}),
    's': () => d && ctl({action:'set', index:selIdx, key:'solo',
                         value:!d.solo}),
    'v': () => d && ctl({action:'view', index:selIdx}),
    ' ': () => { document.getElementById('freq').focus();
                 ev.preventDefault(); },
  };
  if (acts[ev.key]) acts[ev.key]();
});
/* Digital-lab console feed for the demod-view target. */
async function pollConsole() {
  try {
    if (st && st.demods.length) {
      const c = await (await fetch('/api/console?index=' + selIdx)).json();
      document.getElementById('console').textContent =
        (c.text || '').slice(-512);
    }
  } catch (e) {}
  setTimeout(pollConsole, 1500);
}
pollConsole();
function nudge(d) { ctl({action:'nudge', index:null, delta_hz:d}); }
function zoomAt() {
  if (clickFreq !== null)
    ctl({action:'zoom', offset: clickFreq - st.center_freq,
         bandwidth: st.sample_rate / 8});
}
async function setGain(name, v) {
  await fetch('/api/gains', {method:'POST',
    body: JSON.stringify({name: name, value: parseFloat(v)})});
}
async function setAgc(v) {
  await fetch('/api/gains', {method:'POST', body: JSON.stringify({agc: v})});
}
async function bookmarkSel() {
  await fetch('/api/bookmarks', {method:'POST',
    body: JSON.stringify({op:'add', index:0, group:'Ungrouped'})});
}
async function bmGo(grp, i) {
  await fetch('/api/bookmarks', {method:'POST',
    body: JSON.stringify({op:'activate', group:grp, i:i})});
}
async function ppmMeasure() {
  // PPM calibration aid (ref: scope PPM mode + AppFrame PPM dialog):
  // measure a known carrier, show the suggested correction, one click
  // to apply it.
  const ref = parseFloat(document.getElementById('ppmref').value);
  if (!ref) return;
  const m = await (await fetch('/api/ppm?ref=' + ref)).json();
  const o = document.getElementById('ppmout');
  if (!m.ok) { o.textContent = m.error; return; }
  o.innerHTML = `off ${m.offset_hz} Hz (${m.offset_ppm} ppm) ` +
    `<button onclick="ctl({action:'ppm', value:${m.suggested_ppm}})">` +
    `apply ${m.suggested_ppm} ppm</button>`;
}
function bmDrag(ev, grp, i) {
  ev.dataTransfer.setData('text/plain',
    JSON.stringify({kind:'bm', group:grp, i:i}));
}
async function bmDrop(ev, grp, i) {
  ev.preventDefault();
  let d; try { d = JSON.parse(ev.dataTransfer.getData('text/plain')); }
  catch (e) { return; }
  if (d.kind === 'bm' && d.group === grp && i !== null) {
    await fetch('/api/bookmarks', {method:'POST',
      body: JSON.stringify({op:'reorder', group:grp, i:d.i, to:i})});
  } else if (d.kind === 'bm' && d.group !== grp) {
    await fetch('/api/bookmarks', {method:'POST',
      body: JSON.stringify({op:'move', from:d.group, i:d.i, to:grp})});
  } else if (d.kind === 'demod') {
    await fetch('/api/bookmarks', {method:'POST',
      body: JSON.stringify({op:'add', index:d.i, group:grp})});
  }
}
function tune() {
  ctl({action:'tune', freq: parseFloat(document.getElementById('freq').value)});
}
function setTheme() {
  ctl({action:'theme', name: document.getElementById('theme').value});
}
spec.onclick = (ev) => {
  const frac = ev.offsetX / ev.target.width;
  clickFreq = st.center_freq + (frac - 0.5) * st.sample_rate;
  document.getElementById('freq').value = clickFreq;
};
/* Waterfall drag interactions (ref: WaterfallCanvas mouse handlers):
   drag on empty spectrum = CREATE a demod spanning the drag extent;
   drag inside a demod's band = MOVE it; drag near a band edge = RESIZE
   its bandwidth. A tiny drag is a plain click (sets clickFreq). */
let drag = null;
function freqAt(x) {
  return st.center_freq + (x / wf.width - 0.5) * st.sample_rate;
}
function demodAt(f) {
  let hit = null;
  (st ? st.demods : []).forEach((d, i) => {
    if (Math.abs(f - d.frequency) <= d.bandwidth / 2) hit = {d: d, i: i};
  });
  return hit;
}
wf.onmousedown = (ev) => {
  if (!st) return;
  const f = freqAt(ev.offsetX), hit = demodAt(f);
  let mode = 'create';
  if (hit) {
    const edge = Math.abs(Math.abs(f - hit.d.frequency)
                          - hit.d.bandwidth / 2);
    mode = edge < hit.d.bandwidth * 0.15 ? 'resize' : 'move';
  }
  drag = {x0: ev.offsetX, x1: ev.offsetX, mode: mode, hit: hit};
};
wf.onmousemove = (ev) => {
  if (drag) drag.x1 = ev.offsetX;
};
wf.onmouseup = async (ev) => {
  if (!drag) return;
  drag.x1 = ev.offsetX;
  const f0 = freqAt(drag.x0), f1 = freqAt(drag.x1), d = drag;
  drag = null;
  if (Math.abs(d.x1 - d.x0) < 3) {              // plain click
    clickFreq = f1;
    document.getElementById('freq').value = clickFreq;
    return;
  }
  if (d.mode === 'create') {
    const bw = Math.max(Math.abs(f1 - f0), 10000);
    await ctl({action: 'add', freq: (f0 + f1) / 2, type: 'FM',
               bandwidth: bw});
  } else if (d.mode === 'move') {
    await ctl({action: 'set', index: d.hit.i, key: 'frequency',
               value: d.hit.d.frequency + (f1 - f0)});
  } else {                                      // resize by edge drag
    const bw = Math.max(2 * Math.abs(f1 - d.hit.d.frequency), 5000);
    await ctl({action: 'set', index: d.hit.i, key: 'bandwidth',
               value: bw});
  }
};
function addDemod() {
  if (clickFreq !== null)
    ctl({action:'add', freq: clickFreq, type:'FM', bandwidth:200000});
}
function listen() {
  const a = document.getElementById('aud');
  a.style.display = 'block'; a.src = '/api/audio.wav?' + Date.now();
  a.play();
}
async function pollDevices() {
  try {
    const d = await (await fetch('/api/devices')).json();
    const sel = document.getElementById('devsel');
    if (!sel.options.length) for (const e of d.devices) {
      const o = document.createElement('option');
      o.value = e.device_id; o.text = e.name || e.device_id; sel.add(o); }
    if (st && st.display) {
      for (const [id, k] of [['lps','lps'], ['avg','fft_average_rate'],
                             ['snap','snap']]) {
        const el = document.getElementById(id);
        if (document.activeElement !== el) el.value = st.display[k]; }
      document.getElementById('peak').checked = st.display.peak_hold;
      document.getElementById('perf').selectedIndex = st.display.perf_mode;
    }
  } catch (e) {}
  setTimeout(pollDevices, 3000);
}
async function devSelect() {
  const id = document.getElementById('devsel').value;
  await fetch('/api/devices', {method:'POST',
    body: JSON.stringify({op:'select', device_id: id})});
}
async function devCtl(op) {
  await fetch('/api/devices', {method:'POST', body: JSON.stringify({op})});
}
function setDisplay() {
  ctl({action:'display',
       lps: parseFloat(document.getElementById('lps').value),
       fft_average_rate: parseFloat(document.getElementById('avg').value),
       peak_hold: document.getElementById('peak').checked});
}
function setSnap() {
  ctl({action:'snap',
       step: parseInt(document.getElementById('snap').value) || 1});
}
function setPerf() {
  ctl({action:'perf_mode', mode: document.getElementById('perf').value});
}
poll();
pollDevices();
</script></body></html>"""


def _carry_streaming_state(old_rx, old_state, old_keyed, new_rx, new_keyed,
                           new_state):
    """Port streaming state across a plan rebuild.

    The channelizer/DC state carries verbatim when the wideband config is
    unchanged. Per-demod group state (frontend filter tails + NCO phase,
    modem-kit carries, squelch/AGC EMAs) carries ROW-wise: a surviving
    DemodulatorInstance keeps its row state when its group key
    (type, bandwidth, settings) — and hence every leaf's per-row shape —
    is unchanged. New rows keep the cold init value."""
    import jax

    def tree_shapes_equal(a, b):
        la, lb = jax.tree.flatten(a), jax.tree.flatten(b)
        return (la[1] == lb[1] and len(la[0]) == len(lb[0]) and all(
            getattr(x, "shape", None) == getattr(y, "shape", None)
            for x, y in zip(la[0], lb[0])))

    if (old_keyed is not None
            and old_rx.chan_mode == new_rx.chan_mode
            and old_rx.M == new_rx.M
            and old_rx.dtype == new_rx.dtype
            and tree_shapes_equal(old_state["chan"], new_state["chan"])
            and tree_shapes_equal(old_state["dc"], new_state["dc"])):
        # Channelizer/DC tails are history-shaped (block-length independent).
        new_state["chan"] = old_state["chan"]
        new_state["dc"] = old_state["dc"]
    if old_keyed is None:
        return new_state

    old_pos = {}                       # id(instance) -> (key, gi, row)
    for gi, (key, demods) in enumerate(old_keyed.items()):
        for ri, d in enumerate(demods):
            old_pos[id(d)] = (key, gi, ri)

    def port_rows(new_leaf, old_leaf, pairs, n_new, n_old):
        if not hasattr(new_leaf, "shape") or new_leaf.ndim == 0:
            return new_leaf
        # Every group-state leaf (frontend, kit, squelch gate) leads with
        # the per-demod row axis.
        per_demod = (new_leaf.shape[0] == n_new
                     and np.shape(old_leaf)[0] == n_old
                     and new_leaf.shape[1:] == np.shape(old_leaf)[1:])
        if not per_demod:
            # Same shape carries verbatim, otherwise keep the cold init.
            return old_leaf if new_leaf.shape == np.shape(old_leaf) \
                else new_leaf
        buf = np.array(new_leaf)
        old = np.asarray(old_leaf)
        for new_ri, old_ri in pairs:
            buf[new_ri] = old[old_ri]
        return buf

    groups = list(new_state["groups"])
    for gi, (key, demods) in enumerate(new_keyed.items()):
        pairs = []
        for ri, d in enumerate(demods):
            hit = old_pos.get(id(d))
            if hit is not None and hit[0] == key:
                pairs.append((ri, hit[2]))
        if not pairs:
            continue
        old_gi = old_pos[id(demods[pairs[0][0]])][1]
        n_old = len(list(old_keyed.values())[old_gi])
        try:
            groups[gi] = jax.tree.map(
                lambda nl, ol: port_rows(nl, ol, pairs, len(demods), n_old),
                new_state["groups"][gi], old_state["groups"][old_gi])
        except ValueError:
            continue                       # structure changed: start cold
    new_state["groups"] = tuple(groups)
    return new_state


class WebViewer:
    """Serves a LiveReceiver (app/runner.py) plus its DemodulatorMgr."""

    def __init__(self, receiver, mgr=None, keyed=None,
                 host: str = "127.0.0.1", port: int = 8080,
                 bookmarks=None, config=None, device_info=None,
                 source=None, enumerator=None):
        from cubicsdr.app.bookmarks import BookmarkMgr
        from cubicsdr.app.config import AppConfig
        self.receiver = receiver
        self.mgr = mgr
        self.keyed = keyed
        if keyed:
            # Stable per-row identities: recorders/recording flags follow
            # the demod INSTANCE across plan rebuilds, not its row index.
            receiver.row_keys = [d._id for ds in keyed.values()
                                 for d in ds]
        self.bookmarks = bookmarks if bookmarks is not None else BookmarkMgr()
        self.config = config if config is not None else AppConfig()
        from cubicsdr.io.devices import SDREnumerator
        self.device_info = device_info    # SDRDeviceInfo of the live source
        self.source = source              # live source (gain passthrough)
        # App-OWNED enumerator: remote/manual registrations must persist
        # across requests (ref: SDREnumerator static remotes/manuals).
        self.enumerator = enumerator if enumerator is not None \
            else SDREnumerator()
        self.soapy_module = None          # injectable driver (tests: mock)
        self.host, self.port = host, port
        self._lock = threading.Lock()
        self._plan_cache: dict = {}       # plan signature -> pipeline
        self._levels: dict[int, float] = {}
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._consoles: dict[int, object] = {}   # flat idx -> DigitalConsole
        prev = receiver.on_block

        def hook(out):
            lv = []
            off = 0
            for gi, g in enumerate(out.get("groups", [])):
                rows = np.asarray(g["level"]).ravel()
                lv.extend(rows.tolist())
                if "symbols" in g:
                    self._feed_console(gi, off, np.asarray(g["symbols"]))
                off += rows.shape[0]
            with self._lock:
                self._levels = dict(enumerate(lv))
            if prev is not None:
                prev(out)

        receiver.on_block = hook

    def _feed_console(self, gi: int, off: int, symbols: np.ndarray):
        """Live digital-lab console feed (ref: DemodulatorInstance.cpp:
        658-689 console output; src/forms/DigitalConsole)."""
        from cubicsdr.app.digital_console import DigitalConsole
        bps = 1
        try:
            bps = int(self.receiver.pipeline._modems[gi].bits_per_symbol())
        except Exception:
            pass
        for ri in range(symbols.shape[0]):
            key = off + ri
            if key not in self._consoles:
                self._consoles[key] = DigitalConsole(bits_per_symbol=bps)
            self._consoles[key].write_symbols(symbols[ri])

    def console_json(self, index: int, view: str = "text") -> dict:
        c = self._consoles.get(index)
        if c is None:
            return {"index": index, "text": "", "views": []}
        body = (c.hex_view() if view == "hex"
                else c.ascii_view() if view == "ascii" else c.text)
        return {"index": index, "view": view, "text": body[-4096:]}

    # ---- state snapshots -------------------------------------------------
    def _flat_order(self) -> list:
        """Instances in the pipeline's flat group order (keyed iteration) —
        the order of levels/recorder indices; may differ from mgr order."""
        if not self.keyed:
            return list(self.mgr.get_demodulators()) if self.mgr else []
        return [d for ds in self.keyed.values() for d in ds]

    def _row_key_for(self, d):
        """The stable row key of instance ``d`` as the receiver resolves
        it (instance id when row_keys are registered, else the flat row
        index)."""
        for fi, x in enumerate(self._flat_order()):
            if x is d:
                return self.receiver.row_key(fi)
        raise IndexError("demod not in the current plan")

    def _key_mgr_index(self, key):
        """mgr index of a stable row key (for status JSON); None if the
        key no longer resolves."""
        if key is None or self.mgr is None:
            return None
        flat = self._flat_order()
        r = self.receiver
        fi = next((i for i in range(len(flat)) if r.row_key(i) == key),
                  None)
        if fi is None:
            return None
        d = flat[fi]
        return next((mi for mi, x in
                     enumerate(self.mgr.get_demodulators()) if x is d),
                    None)

    def state_json(self) -> dict:
        r = self.receiver
        demods = []
        if self.mgr is not None:
            with self._lock:
                flat_levels = dict(self._levels)
            flat = self._flat_order()
            levels = {id(d): flat_levels.get(fi, 0.0)
                      for fi, d in enumerate(flat)}
            rec_on = {id(d): r.recording_enabled(r.row_key(fi))
                      for fi, d in enumerate(flat)}
            for i, d in enumerate(self.mgr.get_demodulators()):
                demods.append({
                    "index": i, "type": d.demod_type,
                    "frequency": d.frequency, "bandwidth": d.bandwidth,
                    "squelch_level": d.squelch_level,
                    "squelch_enabled": d.squelch_enabled,
                    "gain": d.gain, "muted": d.muted, "solo": d.solo,
                    "active": d.active, "label": d.label,
                    "level": levels.get(id(d), 0.0),
                    "recording": rec_on.get(id(d), False),
                })
        from cubicsdr.visual.gradient import THEMES
        return {
            "center_freq": r.center_freq,
            "sample_rate": r.pipeline.sample_rate,
            "audio_rate": getattr(r.pipeline, "audio_rate", 48000),
            "theme": r.waterfall.theme_name,
            "themes": sorted(THEMES),
            "demods": demods,
            "metrics": r.metrics.snapshot(),
            "display": {**r.display_params(), "snap": self.config.snap,
                        "perf_mode": self.config.perf_mode},
            "record": {"path": r.record_path,
                       "squelch": int(r._rec_opts[0]),
                       "time_limit": r._rec_opts[1]},
            "audio_solo": self._key_mgr_index(r.audio_solo),
        }

    def spectrum_json(self) -> dict:
        pts = self.receiver.waterfall.buffer[-1]   # newest display line
        out = {"points": np.asarray(pts, np.float64).round(4).tolist()}
        z = self.receiver.zoom
        if z is not None:
            out["zoom"] = {
                "offset": z.view_offset, "bandwidth": z.resample_bw,
                "points": [] if z.points is None
                else np.asarray(z.points, np.float64).round(4).tolist()}
        return out

    def demod_spectrum_json(self) -> dict:
        pts = self.receiver.demod_spectrum
        return {"index": self.receiver.demod_view,
                "points": [] if pts is None
                else np.asarray(pts, np.float64).round(4).tolist()}

    def scope_json(self, mode: str = "Y") -> dict:
        """Audio scope traces (ref: ScopeVisualProcessor waveform modes)."""
        from cubicsdr.visual.scope import scope_trace
        with self.receiver.audio_cond:
            chunk = (self.receiver.audio_tap[-1]
                     if self.receiver.audio_tap else None)
        if chunk is None:
            return {"mode": mode, "traces": []}
        tr = np.asarray(scope_trace(np.atleast_2d(chunk), mode))
        tr = tr[..., :: max(1, tr.shape[-1] // 1024)][..., :1024]
        return {"mode": mode,
                "traces": np.asarray(tr, np.float64).round(4).tolist()}

    def stream_audio_wav(self, wfile):
        """Chunked 16-bit WAV stream of the live mix (the web-world
        RtAudio output; plays in an <audio> element)."""
        import struct
        r = self.receiver
        rate = int(getattr(r.pipeline, "audio_rate", 48000))
        ch = 2
        hdr = (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
               + b"fmt " + struct.pack("<IHHIIHH", 16, 1, ch, rate,
                                       rate * ch * 2, ch * 2, 16)
               + b"data" + struct.pack("<I", 0xFFFFFFFF))
        wfile.write(hdr)
        seq = r._audio_seq
        while True:
            with r.audio_cond:
                r.audio_cond.wait_for(lambda: r._audio_seq != seq,
                                      timeout=2.0)
                if r._audio_seq == seq:
                    return                       # stream idle; end
                seq = r._audio_seq
                chunk = r.audio_tap[-1]
            a = np.atleast_2d(chunk)
            if a.shape[0] == 1:
                a = np.concatenate([a, a], axis=0)
            pcm = (np.clip(a.T, -1, 1) * 32767).astype("<i2").tobytes()
            wfile.write(pcm)

    def session_io(self, cmd: dict) -> dict:
        from cubicsdr.app.session import SessionMgr
        sess = SessionMgr(self.mgr)
        sess.center_freq = int(self.receiver.center_freq)
        sess.sample_rate = int(self.receiver.pipeline.sample_rate)
        path = str(cmd["path"])
        if cmd.get("op") == "save":
            sess.save_session(path)
            return {"ok": True, "path": path}
        if cmd.get("op") == "load":
            if not sess.load_session(path):
                return {"ok": False, "error": f"cannot load {path}"}
            self.receiver.center_freq = float(sess.center_freq)
            self._rebuild_plan()
            return {"ok": True, "demods": len(self.mgr.get_demodulators())}
        if cmd.get("op") == "checkpoint":
            # Bit-continuous snapshot of the LIVE streaming state (filter
            # tails, NCO phases, EMA trackers) alongside the session —
            # the resumable-pipeline deliverable (SURVEY §5) for the
            # running app, not just the CLI rx path.
            from cubicsdr.app.checkpoint import save_state
            sess.save_session(path)
            save_state(path + ".state.npz",
                       self.receiver.snapshot_state(),
                       meta={"center": self.receiver.center_freq})
            return {"ok": True, "path": path,
                    "state": path + ".state.npz"}
        if cmd.get("op") == "restore":
            from cubicsdr.app.checkpoint import load_state
            if not sess.load_session(path):
                return {"ok": False, "error": f"cannot load {path}"}
            self.receiver.center_freq = float(sess.center_freq)
            self._rebuild_plan()
            r = self.receiver
            try:
                state, meta = load_state(path + ".state.npz",
                                         r.pipeline.init_state())
            except Exception as e:       # noqa: BLE001 — shape mismatch
                return {"ok": False,
                        "error": f"state restore failed: {e}"}
            with r.step_lock:
                r.state = state
            return {"ok": True,
                    "demods": len(self.mgr.get_demodulators())}
        return {"ok": False,
                "error": "op must be save|load|checkpoint|restore"}

    def waterfall_png(self) -> bytes:
        return self.receiver.waterfall.render_png_bytes()

    # ---- bookmarks (ref: src/forms/Bookmark/BookmarkView.cpp) ------------
    def bookmarks_json(self) -> dict:
        from dataclasses import asdict
        b = self.bookmarks
        return {
            "groups": {g: [asdict(e) for e in b.get_bookmarks(g)]
                       for g in b.get_groups()},
            "recents": [asdict(e) for e in b.recents],
            "ranges": [asdict(r) for r in b.ranges],
        }

    def bookmark_cmd(self, cmd: dict) -> dict:
        """Bookmark surface: the drag/drop + context-menu operations of the
        reference's BookmarkView as REST ops. ``activate`` spawns a demod
        from an entry (double-click analog); adding a demod elsewhere pushes
        recents (ref: BookmarkMgr::addRecent on demod creation)."""
        from cubicsdr.app.bookmarks import BookmarkEntry, BookmarkRange
        b = self.bookmarks
        op = cmd.get("op")
        if op == "add" and self.mgr is not None:
            d = self.mgr.get_demodulators()[int(cmd["index"])]
            b.add_bookmark(str(cmd.get("group", "Ungrouped")),
                           BookmarkEntry.from_demod(d))
        elif op == "remove":
            g = str(cmd["group"])
            b.remove_bookmark(g, b.get_bookmarks(g)[int(cmd["i"])])
        elif op == "move":
            src = str(cmd["from"])
            b.move_bookmark(b.get_bookmarks(src)[int(cmd["i"])],
                            src, str(cmd["to"]))
        elif op == "reorder":
            b.reorder(str(cmd["group"]), int(cmd["i"]), int(cmd["to"]))
        elif op == "rename_group":
            b.rename_group(str(cmd["group"]), str(cmd["new"]))
        elif op == "remove_group":
            b.remove_group(str(cmd["group"]))
        elif op == "activate" and self.mgr is not None:
            src = (b.recents if cmd.get("group") == "recents"
                   else b.get_bookmarks(str(cmd["group"])))
            e = src[int(cmd["i"])]
            d = self.mgr.new_demodulator(e.frequency, e.demod_type,
                                         e.bandwidth)
            d.gain, d.squelch_enabled = e.gain, e.squelch_enabled
            d.squelch_level, d.label = e.squelch_level, e.label
            d.write_modem_settings(dict(e.settings))
            self._rebuild_plan()
        elif op == "range_add":
            b.add_range(BookmarkRange(
                label=str(cmd.get("label", "")),
                freq=float(cmd.get("freq", 0.0)),
                start_freq=float(cmd["start"]), end_freq=float(cmd["end"])))
        elif op == "range_remove":
            b.remove_range(b.ranges[int(cmd["i"])])
        elif op == "range_activate":
            r = b.ranges[int(cmd["i"])]
            self.receiver.center_freq = float(
                r.freq or (r.start_freq + r.end_freq) / 2)
            self._refresh_controls()
        elif op == "save":
            b.save_to_file(str(cmd["path"]))
        elif op == "load":
            if not b.load_from_file(str(cmd["path"])):
                return {"ok": False, "error": "cannot load"}
        else:
            return {"ok": False, "error": f"unknown bookmark op {op}"}
        return {"ok": True}

    # ---- gain stages (ref: src/visual/GainCanvas.cpp per-stage sliders) --
    def ppm_json(self, ref_hz: float) -> dict:
        """PPM calibration aid (ref: the scope's PPM mode + ALT-over-
        tuning-bar interactive correction, src/visual/ScopeCanvas.h:
        35-36,65, src/AppFrame.cpp:2343,1996-2005). Re-design:
        instead of an eyeballed digit bar, measure a KNOWN reference
        carrier's spectral peak (sub-bin parabolic interpolation, the
        zoomed view when it covers the carrier) and report the implied
        correction: SoapySDR applies ``setFrequencyCorrection(ppm)`` so
        a carrier appearing ABOVE where it should means the current
        correction is too high by offset/ref*1e6."""
        r = self.receiver
        ref_hz = float(ref_hz)
        rate = r.pipeline.sample_rate
        src_name = "spectrum"
        z = r.zoom
        if (z is not None and z.points is not None
                and abs(ref_hz - (r.center_freq + z.view_offset))
                < 0.45 * z.resample_bw):
            pts = np.asarray(z.points, np.float64)
            f0 = r.center_freq + z.view_offset - z.resample_bw / 2
            span = z.resample_bw
            src_name = "zoom"
        else:
            pts = np.asarray(r.waterfall.buffer[-1], np.float64)
            f0 = r.center_freq - rate / 2
            span = rate
        n = pts.size
        if n < 8:
            return {"ok": False, "error": "no spectrum yet"}
        binw = span / n
        # Search ±0.5% of the span around the nominal carrier.
        k_ref = (ref_hz - f0) / binw
        if not (1 <= k_ref <= n - 2):
            return {"ok": False,
                    "error": f"reference {ref_hz} Hz outside the "
                             f"{src_name} span"}
        w = max(3, int(0.005 * n))
        lo = max(1, int(k_ref) - w)
        hi = min(n - 1, int(k_ref) + w + 1)
        k = lo + int(np.argmax(pts[lo:hi]))
        ym1, y0, yp1 = pts[k - 1], pts[k], pts[k + 1]
        den = ym1 - 2 * y0 + yp1
        frac = 0.5 * (ym1 - yp1) / den if abs(den) > 1e-12 else 0.0
        # fftshifted display: bin k's center sits at f0 + k*binw.
        f_peak = f0 + (k + float(np.clip(frac, -0.5, 0.5))) * binw
        offset = f_peak - ref_hz
        off_ppm = offset / ref_hz * 1e6
        dev_id = (self.device_info.device_id
                  if self.device_info is not None else "synthetic=0")
        cur = self.config.get_device(dev_id).ppm
        return {"ok": True, "source": src_name,
                "bin_hz": round(binw, 2),
                "reference_hz": ref_hz,
                "measured_peak_hz": round(f_peak, 2),
                "offset_hz": round(offset, 2),
                "offset_ppm": round(off_ppm, 3),
                "current_ppm": cur,
                "suggested_ppm": round(cur - off_ppm, 2)}

    def gains_json(self) -> dict:
        dev = self.device_info
        dev_id = dev.device_id if dev is not None else "synthetic=0"
        dc = self.config.get_device(dev_id)
        stages = []
        caps = dev.gains if dev is not None else {}
        for name, (lo, hi) in caps.items():
            stages.append({"name": name, "min": lo, "max": hi,
                           "value": dc.gains.get(name, lo)})
        return {"device": dev_id, "agc": dc.agc_mode, "stages": stages}

    def gain_cmd(self, cmd: dict) -> dict:
        """Set one gain stage (slider drag analog). Persisted in
        DeviceConfig; forwarded to a live source when attached. Manual gain
        motion drops AGC, like the reference's gain UI."""
        dev = self.device_info
        dev_id = dev.device_id if dev is not None else "synthetic=0"
        dc = self.config.get_device(dev_id)
        if "agc" in cmd:
            dc.agc_mode = bool(cmd["agc"])
            if self.source is not None and hasattr(self.source, "set_agc"):
                self.source.set_agc(dc.agc_mode)
            return {"ok": True, "agc": dc.agc_mode}
        name, value = str(cmd["name"]), float(cmd["value"])
        if dev is not None and name in dev.gains:
            lo, hi = dev.gains[name]
            value = min(max(value, lo), hi)
        dc.gains[name] = value
        dc.agc_mode = False
        if self.source is not None and hasattr(self.source, "set_gain"):
            self.source.set_gain(name, value)
            if hasattr(self.source, "set_agc"):
                self.source.set_agc(False)
        return {"ok": True, "name": name, "value": value}

    # ---- rig integration (ref: src/rig/RigThread.cpp:133-207 poll loop) --
    def attach_rig(self, controller, poll_every_s: float = 0.25):
        """Poll the rig between blocks (the RigThread cadence): follow mode
        retunes the app center from the rig; control mode pushes app tunes
        to the rig; follow-modem tracks the active demod."""
        import time as _time
        self.rig = controller
        r = self.receiver
        controller.get_app_freq = lambda: r.center_freq

        def _set_app_freq(f):
            r.center_freq = float(f)
            self._refresh_controls()

        controller.set_app_freq = _set_app_freq
        state = {"t": 0.0}
        prev = r.on_block

        def hook(out):
            now = _time.monotonic()
            if now - state["t"] >= poll_every_s:
                state["t"] = now
                mf = None
                if controller.follow_modem and self.mgr is not None:
                    d = self.mgr.get_last_active_demodulator()
                    mf = d.frequency if d is not None else None
                controller.poll(modem_freq=mf)
            if prev is not None:
                prev(out)

        r.on_block = hook

    def rig_json(self) -> dict:
        c = getattr(self, "rig", None)
        if c is None:
            return {"attached": False}
        return {"attached": True,
                "frequency": float(c.rig.get_frequency()),
                "control": c.control_mode, "follow": c.follow_mode,
                "center_lock": c.center_lock,
                "follow_modem": c.follow_modem,
                "error": c.last_error.name}

    def rig_cmd(self, cmd: dict) -> dict:
        c = getattr(self, "rig", None)
        if c is None:
            return {"ok": False, "error": "no rig attached"}
        for key in ("control_mode", "follow_mode", "center_lock",
                    "follow_modem"):
            if key in cmd:
                setattr(c, key, bool(cmd[key]))
        if "frequency" in cmd:
            c.rig.set_frequency(float(cmd["frequency"]))
        return {"ok": True, **{k: getattr(c, k) for k in
                               ("control_mode", "follow_mode",
                                "center_lock", "follow_modem")}}

    # ---- modem settings (ref: src/ModemProperties.cpp:1-299 generated
    #      properties panel; schema surface src/modules/modem/Modem.h:
    #      141-146 getSettings/readSetting/writeSetting) -----------------
    def modem_settings_json(self, index: int) -> dict:
        """One demod's typed settings schema + current values — the data
        the reference's ModemProperties panel generates widgets from."""
        demods = self.mgr.get_demodulators() if self.mgr else []
        if not (0 <= index < len(demods)):
            return {"ok": False, "error": f"no demod {index}"}
        d = demods[index]
        args = []
        for a in d.modem.get_settings():
            args.append({
                "key": a.key, "name": a.name, "value": a.value,
                "type": a.arg_type, "units": a.units,
                "description": a.description,
                "low": a.low, "high": a.high, "options": a.options})
        return {"ok": True, "index": index, "type": d.demod_type,
                "settings": d.read_modem_settings(), "schema": args}

    def _write_modem_settings(self, cmd: dict) -> dict:
        """POST action 'modem_settings': validate against the ModemArg
        schema, write onto the LIVE instance, and rebuild the plan —
        settings are part of the compiled group key, so surviving demods
        keep their streaming state (audio never glitches for untouched
        rows) while the edited demod's rows re-kit."""
        d = self.mgr.get_demodulators()[int(cmd["index"])]
        schema = {a.key: a for a in d.modem.get_settings()}
        new = {}
        for k, v in dict(cmd.get("settings", {})).items():
            a = schema.get(k)
            if a is None:
                return {"ok": False, "error": f"unknown setting {k!r} for "
                        f"{d.demod_type}"}
            try:
                v = (int(v) if a.arg_type == "int"
                     else float(v) if a.arg_type == "float" else str(v))
            except (TypeError, ValueError):
                return {"ok": False,
                        "error": f"{k}: expected {a.arg_type}, got {v!r}"}
            if a.options is not None and v not in a.options:
                return {"ok": False,
                        "error": f"{k}: {v!r} not in {a.options}"}
            if a.low is not None and v < a.low \
                    or a.high is not None and v > a.high:
                return {"ok": False, "error":
                        f"{k}: {v} outside [{a.low}, {a.high}]"}
            new[k] = v
        if not new:
            return {"ok": False, "error": "no settings given"}
        d.write_modem_settings(new)
        self._rebuild_plan()
        return {"ok": True, "settings": d.read_modem_settings()}

    # ---- device picker (ref: src/forms/SDRDevices/SDRDevices.cpp) -------
    def devices_json(self) -> dict:
        from dataclasses import asdict
        cur = self.device_info.device_id if self.device_info else None
        devs = []
        for d in self.enumerator.enumerate_devices():
            e = asdict(d)
            dc = self.config.devices.get(d.device_id)
            if dc is not None:             # persisted per-device settings
                e["config"] = {
                    "ppm": dc.ppm, "agc": dc.agc_mode,
                    "sample_rate": dc.sample_rate, "gains": dict(dc.gains),
                    "settings": dict(dc.settings),
                    "stream_opts": dict(dc.stream_opts)}
            devs.append(e)
        p = self.receiver._producer
        return {"current": cur,
                "running": p is not None and p.is_alive(),
                "devices": devs,
                "remotes": list(self.enumerator.remotes),
                "manuals": list(self.enumerator.manuals)}

    def _build_soapy_source(self, info, dc, rate, cmd):
        """Open a SoapySDR device with the persisted DeviceConfig reapplied
        (ppm/gains/AGC/settings + IQ swap; ref: src/CubicSDR.cpp:814-841
        setDevice settings reapply, src/sdr/SoapySDRThread.cpp:305-343)."""
        from cubicsdr.io.soapy import SoapySDRSource
        dev_id = info.device_id
        args = cmd.get("args")
        if args is None:
            if dev_id.startswith("remote="):
                args = f"driver=remote,remote={dev_id.split('=', 1)[1]}"
            elif dev_id.startswith("manual="):
                hit = [m for m in self.enumerator.manuals
                       if m.get("driver", "?") == dev_id.split("=", 1)[1]]
                args = (hit[0].get("args", f"driver={hit[0]['driver']}")
                        if hit else dev_id.replace("manual=", "driver="))
            else:
                args = dev_id
        stream_args = dict(dc.stream_opts)
        stream_args.update(cmd.get("stream_args") or {})
        src = SoapySDRSource(
            args, sample_rate=rate, frequency=self.receiver.center_freq,
            stream_args=stream_args or None, ppm=dc.ppm, agc=dc.agc_mode,
            iq_swap=bool(cmd.get("iq_swap", dc.settings.get("iq_swap",
                                                            False))),
            module=self.soapy_module,
            wire_format=str(cmd.get("wire_format", "cf32")))
        for name, v in dc.gains.items():
            src.set_gain(name, v)
        for k, v in dc.settings.items():
            if k != "iq_swap":
                src.write_setting(k, v)
        if stream_args:
            dc.stream_opts = dict(stream_args)
        return src

    def device_cmd(self, cmd: dict) -> dict:
        """POST /api/devices — runtime device control (the SDRDevices
        dialog's verbs: pick/start a device, keep remotes and manual
        definitions, ref: src/forms/SDRDevices/SDRDevices.cpp:1-628,
        src/CubicSDR.cpp:614-622 remote add/remove, :797-855 setDevice)."""
        from cubicsdr.io.sources import (FileIQSource, SyntheticSource,
                                         Station)
        r = self.receiver
        op = cmd.get("op", "select")
        if op == "add_remote":
            self.enumerator.add_remote(str(cmd["address"]))
            return {"ok": True, "remotes": list(self.enumerator.remotes)}
        if op == "remove_remote":
            self.enumerator.remove_remote(str(cmd["address"]))
            return {"ok": True, "remotes": list(self.enumerator.remotes)}
        if op == "set_manuals":
            self.enumerator.set_manuals(list(cmd["manuals"]))
            return {"ok": True, "manuals": list(self.enumerator.manuals)}
        if op == "stop":
            r.stop_producer()
            return {"ok": True, "running": False}
        if op == "start":
            if r._producer is None or not r._producer.is_alive():
                r.start_producer()       # source.__iter__ clears stop latch
            return {"ok": True, "running": True}
        if op != "select":
            return {"ok": False, "error": f"unknown device op {op}"}

        dev_id = str(cmd["device_id"])
        info = next((d for d in self.enumerator.enumerate_devices()
                     if d.device_id == dev_id), None)
        if info is None and dev_id.startswith(("file=", "net=")):
            from cubicsdr.io.devices import SDRDeviceInfo
            kind = dev_id.split("=", 1)[0]
            info = SDRDeviceInfo(dev_id, dev_id, kind)
        if info is None:
            return {"ok": False, "error": f"no such device {dev_id}"}
        dc = self.config.get_device(dev_id)
        rate = float(cmd.get("rate") or dc.sample_rate
                     or r.pipeline.sample_rate)
        if info.driver not in ("synthetic", "file", "net"):
            rate = float(info.get_rate_near(rate))

        src = None
        if info.driver in ("soapy", "remote", "manual") \
                or dev_id.startswith(("soapy=", "remote=", "manual=")):
            # Hardware first: the APPLIED rate decides the pipeline.
            src = self._build_soapy_source(info, dc, rate, cmd)
            rate = float(src.sample_rate)

        if rate != r.pipeline.sample_rate:
            self._rebuild_plan(sample_rate=rate)
        if src is not None:
            src.set_block_len(r.pipeline.block_len)
        elif info.driver == "file":
            src = FileIQSource(dev_id.split("=", 1)[1], rate,
                               r.pipeline.block_len, loop=True)
        elif info.driver == "net":
            from cubicsdr.io.net import SocketIQSource
            host, port = dev_id.split("=", 1)[1].rsplit(":", 1)
            src = SocketIQSource(host, int(port))
        else:                                    # synthetic
            src = SyntheticSource(
                rate, r.pipeline.block_len,
                [Station(200e3, "fm", audio_freq=1000.0),
                 Station(-300e3, "am", audio_freq=600.0)])
        r.set_source(src)
        self.source = src
        self.device_info = info
        dc.sample_rate = int(rate)               # persisted DeviceConfig
        return {"ok": True, "device": dev_id, "rate": rate,
                "block_len": r.pipeline.block_len}

    # ---- control ---------------------------------------------------------
    def control(self, cmd: dict) -> dict:
        r = self.receiver
        action = cmd.get("action")
        if action == "tune":
            f = float(cmd["freq"])
            default_snap = self.config.snap if self.config.snap > 1 else 0
            snap = float(cmd.get("snap", default_snap) or 0)
            if snap > 0:                 # snap-to-step (ref: snap mode,
                f = round(f / snap) * snap   # AppFrame frequency snap)
            r.center_freq = f
            self._refresh_controls()
        elif action == "nudge":
            # Digit-bar stepping (ref: src/visual/TuningCanvas.cpp digit
            # +/- hover-click; AppFrame arrow hotkeys): move the center or
            # one demod by +/-delta_hz.
            delta = float(cmd["delta_hz"])
            tgt = cmd.get("index")
            if tgt is None:
                r.center_freq += delta
            else:
                d = self.mgr.get_demodulators()[int(tgt)]
                d.frequency = max(0.0, d.frequency + delta)
            self._refresh_controls()
        elif action == "theme":
            r.waterfall.set_theme(str(cmd["name"]))
        elif action == "zoom":
            # Zoomed main-spectrum view: {offset, bandwidth} or offset=null
            # disables. Pans/rescales the smoothed display (continuity).
            off = cmd.get("offset")
            r.set_zoom(None if off is None else float(off),
                       float(cmd.get("bandwidth") or 0.0))
        elif action == "display":
            # Per-canvas display parameters (ref: AppFrame display menus,
            # src/AppFrame.cpp:2320-2352): waterfall lines-per-second,
            # spectrum averaging speed, peak hold, demod-view FFT size.
            r.set_display(lps=cmd.get("lps"),
                          fft_average_rate=cmd.get("fft_average_rate"),
                          peak_hold=cmd.get("peak_hold"),
                          demod_view_fft=cmd.get("demod_view_fft"))
        elif action == "snap":
            # Persistent tuning snap step (ref: AppConfig snap; 0/1 = off).
            self.config.snap = max(1, int(cmd["step"]))
        elif action == "perf_mode":
            # LOW/NORMAL/HIGH throttling (ref: AppFrame.cpp:2207-2215):
            # LOW caps the waterfall pace, HIGH restores the full rate.
            from cubicsdr.app.config import (PERF_LOW, PERF_NORMAL,
                                             PERF_HIGH)
            mode = {"low": PERF_LOW, "normal": PERF_NORMAL,
                    "high": PERF_HIGH}[str(cmd["mode"]).lower()]
            self.config.perf_mode = mode
            caps = {PERF_LOW: 8.0, PERF_NORMAL: 30.0, PERF_HIGH: None}
            cap = caps[mode]
            if cap is not None and r.dist.lps > cap:
                r.set_display(lps=cap)
        elif action == "ppm":
            # Device frequency correction (ref: AppFrame::
            # actionOnMenuSetPPM src/AppFrame.cpp:1996-2005 + the
            # ALT-digit-bar interactive adjust :2343): absolute
            # ``value`` or relative ``delta``, persisted per device and
            # forwarded live. /api/ppm?ref=<Hz> measures the suggested
            # value from a known carrier.
            dev_id = (self.device_info.device_id
                      if self.device_info is not None else "synthetic=0")
            dc = self.config.get_device(dev_id)
            if "value" in cmd and cmd["value"] is not None:
                dc.ppm = int(cmd["value"])
            elif "delta" in cmd:
                dc.ppm = int(dc.ppm + cmd["delta"])
            if self.source is not None and hasattr(self.source,
                                                   "set_ppm"):
                self.source.set_ppm(dc.ppm)
            return {"ok": True, "ppm": dc.ppm}
        elif action == "audio_output":
            # Host playback sinks (RtAudio role): backend auto|
            # sounddevice|wav:<path>|null (null/missing backend detaches).
            # With "demods": [mgr indices], the named sink (default:
            # "default") plays a HOST-MIXED subset — several sinks run
            # at once, the reference's per-demod output-device routing
            # (ref: src/audio/AudioThread.cpp:370-442).
            name = str(cmd.get("name", "default"))
            demods = cmd.get("demods")
            if demods is not None:
                # Subsets are stored as STABLE instance ids and resolved
                # to rows at fanout time against the block's dispatch
                # keys — a plan rebuild that reorders/removes rows can
                # never route another demod's audio into this sink.
                all_d = self.mgr.get_demodulators() if self.mgr else []
                try:
                    sel = [self._row_key_for(all_d[int(i)])
                           for i in demods]
                except IndexError:
                    return {"ok": False,
                            "error": f"bad demod index in {demods}"}
                r.set_audio_sink(name, cmd.get("backend"),
                                 device=cmd.get("device"), demods=sel,
                                 rate=cmd.get("rate"))
            elif name != "default":
                r.set_audio_sink(name, cmd.get("backend"),
                                 device=cmd.get("device"),
                                 rate=cmd.get("rate"))
            else:
                r.set_audio_output(cmd.get("backend"),
                                   device=cmd.get("device"),
                                   rate=cmd.get("rate"))
        elif action == "audio_solo" and self.mgr is not None:
            # Route ONE demod to the host audio device instead of the mix
            # (per-demod output routing, ref: AudioThread bound threads).
            idx = cmd.get("index")
            if idx is None:
                r.set_audio_solo(None)
            else:
                # Stable row key (instance id): survives plan rebuilds.
                r.set_audio_solo(self._row_key_for(
                    self.mgr.get_demodulators()[int(idx)]))
        elif action == "view" and self.mgr is not None:
            # Select the demod-view spectrum target (mgr index or null).
            idx = cmd.get("index")
            if idx is None:
                r.set_demod_view(None)
            else:
                d = self.mgr.get_demodulators()[int(idx)]
                flat = self._flat_order()
                r.set_demod_view(
                    next(fi for fi, x in enumerate(flat) if x is d))
        elif action == "profile":
            # Structured tracing (SURVEY §5: the reference has only
            # stdout anomaly prints; here a real profiler surface): dump
            # a JAX/XLA trace of the next ``seconds`` of live streaming
            # to ``path`` for TensorBoard/xprof.
            import jax.profiler
            path = str(cmd.get("path", "/tmp/cubicsdr_trace"))
            seconds = float(cmd.get("seconds", 2.0))
            if getattr(self, "_profiling", False):
                return {"ok": False, "error": "profile already running"}
            self._profiling = True
            jax.profiler.start_trace(path)

            def _stop():
                import time as _t
                _t.sleep(seconds)
                try:
                    jax.profiler.stop_trace()
                finally:
                    self._profiling = False

            threading.Thread(target=_stop, daemon=True).start()
            return {"ok": True, "path": path, "seconds": seconds}
        elif action == "record_opts":
            # Runtime recording options (ref: AppFrame recording-options
            # menu; src/audio/AudioSinkFileThread.cpp:28-73).
            from cubicsdr.io.recorder import SquelchOption
            sq_map = {"silence": SquelchOption.RECORD_SILENCE,
                      "skip": SquelchOption.SKIP_SILENCE,
                      "always": SquelchOption.RECORD_ALWAYS}
            sq = cmd.get("squelch")
            if sq is not None and sq not in sq_map:
                return {"ok": False,
                        "error": f"squelch must be one of {list(sq_map)}"}
            r.set_record_options(
                squelch=sq_map[sq] if sq is not None else None,
                time_limit=cmd.get("time_limit"), path=cmd.get("path"))
            if cmd.get("path"):
                self.config.recording_path = str(cmd["path"])
        elif action == "modem_settings" and self.mgr is not None:
            return self._write_modem_settings(cmd)
        elif action == "set" and self.mgr is not None:
            d = self.mgr.get_demodulators()[int(cmd["index"])]
            key, value = cmd["key"], cmd["value"]
            if key == "frequency":
                d.frequency = float(value)
            elif key == "bandwidth":
                # Bandwidth is part of the compiled group key: an edit
                # that actually changes it needs a plan rebuild (with
                # state carry) before it takes effect on the stream.
                old_bw = int(d.bandwidth)
                d.set_bandwidth(float(value))
                if int(d.bandwidth) != old_bw:
                    self._rebuild_plan()
            elif key == "type":
                # Modem swap on a live demod (ref: ModeSelectorCanvas ->
                # DemodulatorInstance::setDemodulatorType, src/demod/
                # DemodulatorInstance.cpp:359-458).
                d.set_demod_type(str(value))
                self._rebuild_plan()
            elif key == "squelch_level":
                d.squelch_level = float(value)
            elif key == "squelch_enabled":
                d.squelch_enabled = bool(value)
            elif key == "gain":
                d.gain = float(value)
            elif key == "mute":
                d.muted = bool(value)
            elif key == "solo":
                d.solo = bool(value)
            elif key == "active":
                d.active = bool(value)
            elif key == "follow":
                d.follow = bool(value)
            elif key == "tracking":
                d.tracking = bool(value)
            elif key == "delta_lock":
                # Enabling captures the current offset from the device
                # center (ref: DemodulatorInstance delta-lock + AppFrame
                # toggle semantics).
                d.delta_lock = bool(value)
                if d.delta_lock:
                    d.delta_lock_ofs = int(
                        d.frequency - self.receiver.center_freq)
            elif key == "label":
                d.label = str(value)
            elif key == "recording":
                # Per-demod recording attach/detach at runtime (the 'R'
                # hotkey, ref: src/demod/DemodulatorInstance.cpp:600-655).
                # Keyed by the INSTANCE id so the WAV follows the demod
                # across plan rebuilds.
                if d.modem.modem_type == "digital":
                    return {"ok": False, "error":
                            f"{d.demod_type} emits symbols, not audio; "
                            "use the digital console"}
                d.recording = bool(value)
                path = (cmd.get("path") or r.record_path
                        or self.config.recording_path or "recording")
                r.set_recording(d._id, bool(value),
                                path=path if value else None)
            else:
                return {"ok": False, "error": f"unknown key {key}"}
            self._refresh_controls()
        elif action == "add" and self.mgr is not None:
            d = self.mgr.new_demodulator(float(cmd["freq"]),
                                         str(cmd.get("type", "FM")),
                                         float(cmd.get("bandwidth", 200000)))
            # New demods land in recents (ref: BookmarkMgr::addRecent fed
            # from DemodulatorMgr updates).
            from cubicsdr.app.bookmarks import BookmarkEntry
            self.bookmarks.add_recent(BookmarkEntry.from_demod(d))
            self._rebuild_plan()
        elif action == "remove" and self.mgr is not None:
            inst = self.mgr.get_demodulators()[int(cmd["index"])]
            self.mgr.delete_demodulator(inst)
            self._rebuild_plan()
        else:
            return {"ok": False, "error": f"unknown action {action}"}
        return {"ok": True}

    def _refresh_controls(self):
        """Controls are traced jit inputs — rebuilding them never
        recompiles (the reference's atomic-flag retune protocol,
        ref: src/demod/DemodulatorPreThread.cpp:281-336)."""
        if self.mgr is None or self.keyed is None:
            return
        from cubicsdr.receiver.pipeline import controls_from_manager
        r = self.receiver
        # Follow / delta-lock / range sweep first: it may move demods (delta
        # lock rides the center) or the center itself (follow retune) —
        # ref: SDRPostThread.cpp:44-98 (run per block there; re-run here
        # once when the center moved so newly-in-range demods reactivate,
        # as the reference's next block pass would).
        for _ in range(2):
            new_center = self.mgr.update_active_demodulators(
                r.center_freq, r.pipeline.sample_rate)
            moved, r.center_freq = new_center != r.center_freq, new_center
            if not moved:
                break
        self.receiver.controls = controls_from_manager(
            self.mgr, r.pipeline, self.keyed, r.center_freq)

    def _rebuild_plan(self, sample_rate=None):
        """Demod add/remove changes group shapes => new compiled plan,
        swapped in between blocks while streaming continues on the old one
        (the DemodulatorWorkerThread pattern). Streaming state of every
        SURVIVING demod row — filter histories, NCO phase, AGC/squelch
        EMAs — is carried over by (type, bandwidth, settings, instance)
        identity so audio stays continuous; only new rows start cold
        (ref: src/demod/DemodulatorPreThread.cpp:105-151, where retune/
        rebuild never glitches the other demods)."""
        from cubicsdr.receiver.pipeline import (
            ReceiverPipeline, plan_from_manager, controls_from_manager)
        r = self.receiver
        # Host snapshot under the step lock: with donated state buffers,
        # r.state may alias a buffer the in-flight step is consuming.
        old_rx, old_state, old_keyed = (r.pipeline, r.snapshot_state(),
                                        self.keyed)
        rate_changed = (sample_rate is not None
                        and float(sample_rate) != old_rx.sample_rate)
        rate = float(sample_rate) if rate_changed else old_rx.sample_rate
        specs, keyed = plan_from_manager(self.mgr)
        base = dict(chan_mode=old_rx.chan_mode, audio_rate=old_rx.audio_rate,
                    dtype=old_rx.dtype)
        if not rate_changed:
            # Keep the wideband format; a rate change re-derives the
            # channel count (numChannels = ceil(rate/500k), ref:
            # SoapySDRThread.cpp:676-693) and the block size.
            base["num_channels"] = old_rx.M
            if old_rx.block_len_explicit:
                base["block_len"] = old_rx.block_len
        # Plan cache: churn that returns to a previously-built plan
        # (add/remove cycles, modem swap and back) reuses the SAME
        # pipeline object, which lets the receiver's compiled-step cache
        # skip the re-trace/re-compile entirely — a cold plan compile
        # stalls the consumer and would starve the live ring.
        sig = (rate, tuple(specs), base["chan_mode"], base["audio_rate"],
               id(base["dtype"]),
               base.get("num_channels"), base.get("block_len"))
        pipeline = self._plan_cache.get(sig)
        if pipeline is None:
            try:
                pipeline = ReceiverPipeline(rate, specs, **base)
            except AssertionError:
                # The pinned block size doesn't divide the new plan's
                # multiples; fall back to a derived one.
                base.pop("block_len", None)
                pipeline = ReceiverPipeline(rate, specs, **base)
            if len(self._plan_cache) >= 8:
                self._plan_cache.pop(next(iter(self._plan_cache)))
            self._plan_cache[sig] = pipeline
        controls = controls_from_manager(self.mgr, pipeline, keyed,
                                         r.center_freq)
        state = pipeline.init_state()
        if not rate_changed:
            state = _carry_streaming_state(old_rx, old_state, old_keyed,
                                           pipeline, keyed, state)
        self._consoles.clear()
        # Recorders/recording flags are keyed by INSTANCE id (row_keys),
        # so a rebuild only needs the new row order registered and the
        # sinks of REMOVED demods finalized. (The demod view resets
        # inside swap_pipeline, atomically with the row swap.)
        new_flat = [d for ds in keyed.values() for d in ds]
        live_ids = {d._id for d in new_flat}
        for rid in [k for k in r._recorders if k not in live_ids]:
            r._recorders.pop(rid).close()
        r.rec_override = {k: v for k, v in r.rec_override.items()
                          if k in live_ids}
        # Audio routing is key-addressed too: prune subset/solo keys of
        # removed demods (a sink with an emptied subset stays attached
        # and plays silence, like an unplugged bound thread).
        for s in r.audio_sinks.values():
            if s["demods"] is not None:
                s["demods"] = [k for k in s["demods"] if k in live_ids]
        if r.audio_solo is not None and r.audio_solo not in live_ids:
            r.audio_solo = None
        with self._lock:
            self.keyed = keyed
            r.swap_pipeline(pipeline, controls, state,
                            row_keys=[d._id for d in new_flat])

    # ---- server ----------------------------------------------------------
    def _handler_class(self):
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                try:
                    if path == "/":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif path == "/api/state":
                        self._send(200,
                                   json.dumps(viewer.state_json()).encode())
                    elif path == "/api/spectrum":
                        self._send(
                            200, json.dumps(viewer.spectrum_json()).encode())
                    elif path == "/api/demod_spectrum":
                        self._send(200, json.dumps(
                            viewer.demod_spectrum_json()).encode())
                    elif path == "/api/scope":
                        q = self.path.split("?", 1)
                        mode = "Y"
                        if len(q) > 1 and "mode=" in q[1]:
                            mode = q[1].split("mode=")[1].split("&")[0]
                        self._send(200, json.dumps(
                            viewer.scope_json(mode)).encode())
                    elif path == "/api/audio.wav":
                        self.send_response(200)
                        self.send_header("Content-Type", "audio/wav")
                        self.send_header("Cache-Control", "no-store")
                        self.end_headers()
                        try:
                            viewer.stream_audio_wav(self.wfile)
                        except (BrokenPipeError, ConnectionResetError):
                            pass
                    elif path == "/api/waterfall.png":
                        self._send(200, viewer.waterfall_png(), "image/png")
                    elif path == "/api/bookmarks":
                        self._send(200, json.dumps(
                            viewer.bookmarks_json()).encode())
                    elif path == "/api/gains":
                        self._send(200,
                                   json.dumps(viewer.gains_json()).encode())
                    elif path.startswith("/api/ppm"):
                        q = dict(p.split("=", 1) for p in
                                 (self.path.split("?", 1) + [""])[1]
                                 .split("&") if "=" in p)
                        self._send(200, json.dumps(viewer.ppm_json(
                            float(q.get("ref", 0) or 0))).encode())
                    elif path == "/api/devices":
                        self._send(200,
                                   json.dumps(viewer.devices_json()).encode())
                    elif path == "/api/audio_devices":
                        from cubicsdr.io.audio_out import (
                            enumerate_output_devices)
                        self._send(200, json.dumps({
                            "devices": enumerate_output_devices(),
                            "backend": (viewer.receiver.audio_output.backend
                                        if viewer.receiver.audio_output
                                        else None),
                            "solo": viewer._key_mgr_index(
                                viewer.receiver.audio_solo),
                            "sinks": {
                                n: {"backend": s["output"].backend,
                                    "rate": s["output"].sample_rate,
                                    "demods": s["demods"]}
                                for n, s in
                                viewer.receiver.audio_sinks.items()},
                        }).encode())
                    elif path == "/api/rig":
                        self._send(200,
                                   json.dumps(viewer.rig_json()).encode())
                    elif path == "/api/modem_settings":
                        q = dict(p.split("=", 1) for p in
                                 (self.path.split("?", 1) + [""])[1].split(
                                     "&") if "=" in p)
                        self._send(200, json.dumps(
                            viewer.modem_settings_json(
                                int(q.get("index", 0)))).encode())
                    elif path == "/api/console":
                        q = dict(p.split("=", 1) for p in
                                 (self.path.split("?", 1) + [""])[1].split(
                                     "&") if "=" in p)
                        self._send(200, json.dumps(viewer.console_json(
                            int(q.get("index", 0)),
                            q.get("view", "text"))).encode())
                    else:
                        self._send(404, b'{"error":"not found"}')
                except Exception as e:      # noqa: BLE001
                    self._send(500, json.dumps({"error": str(e)}).encode())

            def do_POST(self):
                path = self.path.split("?")[0]
                n = int(self.headers.get("Content-Length", 0))
                try:
                    cmd = json.loads(self.rfile.read(n) or b"{}")
                    if path == "/api/control":
                        self._send(200,
                                   json.dumps(viewer.control(cmd)).encode())
                    elif path == "/api/bookmarks":
                        self._send(200, json.dumps(
                            viewer.bookmark_cmd(cmd)).encode())
                    elif path == "/api/gains":
                        self._send(200,
                                   json.dumps(viewer.gain_cmd(cmd)).encode())
                    elif path == "/api/rig":
                        self._send(200,
                                   json.dumps(viewer.rig_cmd(cmd)).encode())
                    elif path == "/api/devices":
                        self._send(200,
                                   json.dumps(viewer.device_cmd(cmd))
                                   .encode())
                    elif path == "/api/session":
                        self._send(200,
                                   json.dumps(viewer.session_io(cmd))
                                   .encode())
                    else:
                        self._send(404, b'{"error":"not found"}')
                except Exception as e:      # noqa: BLE001
                    self._send(400, json.dumps({"error": str(e)}).encode())

        return Handler

    def start(self):
        self._httpd = ThreadingHTTPServer((self.host, self.port),
                                          self._handler_class())
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
