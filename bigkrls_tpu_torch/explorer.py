"""Interactive marginal-effects explorer — a standalone HTML file.
Ported from ``bigkrls_tpu/explorer.py`` (numpy only; the page is the same
but for the default tab title, which names this package).

This is the interactive replacement for the reference's Shiny app
(``shiny.bigKRLS``, ``R/bigKRLS.R:1041-1114``).  The reference app serves
two dropdowns — one selecting which pointwise derivative dy/dxₚ to show,
one selecting which predictor xₚ to scatter it against — with a loess
smoother and a horizontal line at zero (``:1056-1096``).  ``shiny.bigKRLS``
needs a live R process; here :func:`effects_explorer` writes a single
self-contained HTML file (inline data, no external assets, no server),
which covers both the interactive use and the ``export=TRUE`` deployment
mode (``:1098-1110``) at once: the file *is* the deployable artifact.

Features beyond the reference app: hover tooltip with per-observation
values, a table view (AME t-table + marginal-effect percentiles, i.e. the
``summary.bigKRLS`` tables), and automatic light/dark theming.
"""
from __future__ import annotations

import html
import json
import os
from typing import Optional

import numpy as np

from .inference import summary as _summary
from .types import KRLSModel

# Deterministic cap on embedded points: keeps the HTML small and the
# browser responsive at large N.  The UI states the subsample explicitly
# (never a silent cap).
_MAX_POINTS = 8000

_TEMPLATE = """<!doctype html>
<html lang="en">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<title>__TAB_TITLE__</title>
<style>
  .viz-root {
    color-scheme: light;
    --surface-1: #fcfcfb;
    --page: #f9f9f7;
    --text-primary: #0b0b0b;
    --text-secondary: #52514e;
    --text-muted: #898781;
    --gridline: #e1e0d9;
    --baseline: #c3c2b7;
    --series-1: #2a78d6;
    --series-1-strong: #1c5cab;
    --border: rgba(11,11,11,0.10);
  }
  @media (prefers-color-scheme: dark) {
    :root:where(:not([data-theme="light"])) .viz-root {
      color-scheme: dark;
      --surface-1: #1a1a19;
      --page: #0d0d0d;
      --text-primary: #ffffff;
      --text-secondary: #c3c2b7;
      --text-muted: #898781;
      --gridline: #2c2c2a;
      --baseline: #383835;
      --series-1: #3987e5;
      --series-1-strong: #6da7ec;
      --border: rgba(255,255,255,0.10);
    }
  }
  :root[data-theme="dark"] .viz-root {
    color-scheme: dark;
    --surface-1: #1a1a19;
    --page: #0d0d0d;
    --text-primary: #ffffff;
    --text-secondary: #c3c2b7;
    --text-muted: #898781;
    --gridline: #2c2c2a;
    --baseline: #383835;
    --series-1: #3987e5;
    --series-1-strong: #6da7ec;
    --border: rgba(255,255,255,0.10);
  }
  body { margin: 0; }
  .viz-root {
    font-family: system-ui, -apple-system, "Segoe UI", sans-serif;
    background: var(--page); color: var(--text-primary);
    min-height: 100vh; padding: 24px;
    box-sizing: border-box;
  }
  .card {
    max-width: 880px; margin: 0 auto; background: var(--surface-1);
    border: 1px solid var(--border); border-radius: 8px; padding: 20px 24px;
  }
  h1 { font-size: 17px; font-weight: 600; margin: 0 0 2px; }
  .sub { color: var(--text-secondary); font-size: 12.5px; margin: 0 0 14px; }
  .controls { display: flex; gap: 12px; flex-wrap: wrap; align-items: end;
              margin-bottom: 10px; }
  .ctl label { display: block; font-size: 11.5px; color: var(--text-muted);
               margin-bottom: 3px; }
  select, button {
    font: inherit; font-size: 13px; color: var(--text-primary);
    background: var(--surface-1); border: 1px solid var(--border);
    border-radius: 6px; padding: 5px 8px;
  }
  button { cursor: pointer; }
  svg text { font-family: inherit; }
  .axis-label { fill: var(--text-muted); font-size: 11px; }
  .tick-label { fill: var(--text-muted); font-size: 10.5px;
                font-variant-numeric: tabular-nums; }
  .note { color: var(--text-muted); font-size: 11.5px; margin-top: 8px; }
  #tooltip {
    position: fixed; pointer-events: none; display: none; z-index: 10;
    background: var(--surface-1); border: 1px solid var(--border);
    border-radius: 6px; padding: 6px 9px; font-size: 12px;
    color: var(--text-primary); box-shadow: 0 2px 8px rgba(0,0,0,0.18);
  }
  #tooltip .tl { color: var(--text-secondary); }
  table { border-collapse: collapse; font-size: 12.5px; margin-top: 10px;
          width: 100%; }
  caption { text-align: left; font-weight: 600; font-size: 12.5px;
            padding: 6px 0; color: var(--text-primary); }
  th { text-align: right; color: var(--text-muted); font-weight: 500;
       border-bottom: 1px solid var(--gridline); padding: 4px 10px; }
  th:first-child, td:first-child { text-align: left; padding-left: 0; }
  td { text-align: right; padding: 4px 10px;
       font-variant-numeric: tabular-nums;
       border-bottom: 1px solid var(--gridline); }
  .hidden { display: none; }
</style>
</head>
<body>
<div class="viz-root">
  <div class="card">
    <h1>__PAGE_TITLE__</h1>
    <p class="sub" id="meta"></p>
    <div class="controls">
      <div class="ctl"><label for="dsel">marginal effect</label>
        <select id="dsel"></select></div>
      <div class="ctl"><label for="xsel">against predictor</label>
        <select id="xsel"></select></div>
      <div class="ctl"><button id="tbl">table view</button></div>
    </div>
    <div id="chart"></div>
    <div id="tables" class="hidden"></div>
    <p class="note" id="note"></p>
  </div>
</div>
<div id="tooltip"></div>
<script>
const DATA = __PAYLOAD__;
// labels arrive RAW in the JSON payload; escape exactly once, at each
// innerHTML sink (textContent sinks — the dropdowns, the meta line —
// consume the raw strings directly)
const esc = s => String(s).replace(/&/g, '&amp;').replace(/</g, '&lt;')
  .replace(/>/g, '&gt;').replace(/"/g, '&quot;');
const W = 820, H = 430, M = {t: 14, r: 16, b: 44, l: 58};
const dsel = document.getElementById('dsel'),
      xsel = document.getElementById('xsel'),
      chart = document.getElementById('chart'),
      tables = document.getElementById('tables'),
      tip = document.getElementById('tooltip');

DATA.dlabels.forEach((lab, i) => {
  const o = document.createElement('option');
  o.value = i; o.textContent = 'dy/dx: ' + lab; dsel.appendChild(o);
});
DATA.xlabs.forEach((lab, i) => {
  const o = document.createElement('option');
  o.value = i; o.textContent = lab; xsel.appendChild(o);
});
xsel.value = DATA.which[0];
document.getElementById('meta').textContent =
  `N = ${DATA.N}   \\u03bb = ${DATA.lambda.toPrecision(4)}   ` +
  `R\\u00b2 = ${DATA.R2.toFixed(4)}` +
  (DATA.R2AME == null ? '' : `   R\\u00b2AME = ${DATA.R2AME.toFixed(4)}`);
document.getElementById('note').textContent =
  (DATA.subsampled ? `Showing a deterministic subsample of ` +
   `${DATA.points} of ${DATA.N} observations. ` : '') +
  `Smoother: local quadratic (tricube weights). ` +
  `Binary predictors (*) show exact min\\u2192max first differences.`;

function fmt(v, digits) {
  if (!isFinite(v)) return String(v);
  const a = Math.abs(v);
  if (a !== 0 && (a < 1e-3 || a >= 1e5)) return v.toExponential(digits ?? 2);
  return v.toFixed(digits ?? 3);
}
function niceTicks(lo, hi, n) {
  if (lo === hi) { lo -= 1; hi += 1; }
  const span = hi - lo, step0 = span / n,
        mag = Math.pow(10, Math.floor(Math.log10(step0))),
        norm = step0 / mag,
        step = (norm < 1.5 ? 1 : norm < 3.5 ? 2 : norm < 7.5 ? 5 : 10) * mag,
        t0 = Math.ceil(lo / step) * step, out = [];
  for (let t = t0; t <= hi + 1e-12 * span; t += step) out.push(t);
  return out;
}
// local-quadratic smoother with tricube weights (stand-in for the
// reference app's loess line)
function smooth(xs, ys) {
  const n = xs.length, idx = xs.map((_, i) => i).sort((a, b) => xs[a] - xs[b]);
  const sx = idx.map(i => xs[i]), sy = idx.map(i => ys[i]);
  const k = Math.max(Math.floor(0.4 * n), 5), num = 80, out = [];
  const lo = sx[0], hi = sx[n - 1];
  for (let g = 0; g < num; g++) {
    const x0 = lo + (hi - lo) * g / (num - 1);
    const d = sx.map(v => Math.abs(v - x0));
    const ord = d.map((_, i) => i).sort((a, b) => d[a] - d[b]).slice(0, k);
    const dmax = Math.max(d[ord[ord.length - 1]], 1e-12);
    // weighted least squares on [1, dx, dx^2]: solve the 3x3 normal system
    let S = [[0,0,0],[0,0,0],[0,0,0]], b = [0,0,0];
    for (const i of ord) {
      const w = Math.pow(1 - Math.pow(d[i] / dmax, 3), 3);
      const dx = sx[i] - x0, r = [1, dx, dx * dx];
      for (let a = 0; a < 3; a++) {
        b[a] += w * r[a] * sy[i];
        for (let c = 0; c < 3; c++) S[a][c] += w * r[a] * r[c];
      }
    }
    for (let a = 0; a < 3; a++) S[a][a] += 1e-10;
    // Gaussian elimination
    for (let col = 0; col < 3; col++) {
      let piv = col;
      for (let r2 = col + 1; r2 < 3; r2++)
        if (Math.abs(S[r2][col]) > Math.abs(S[piv][col])) piv = r2;
      [S[col], S[piv]] = [S[piv], S[col]]; [b[col], b[piv]] = [b[piv], b[col]];
      for (let r2 = col + 1; r2 < 3; r2++) {
        const f = S[r2][col] / S[col][col];
        for (let c = col; c < 3; c++) S[r2][c] -= f * S[col][c];
        b[r2] -= f * b[col];
      }
    }
    const sol = [0,0,0];
    for (let r2 = 2; r2 >= 0; r2--) {
      let s = b[r2];
      for (let c = r2 + 1; c < 3; c++) s -= S[r2][c] * sol[c];
      sol[r2] = s / S[r2][r2];
    }
    out.push([x0, sol[0]]);
  }
  return out;
}

let pts = [];   // screen-space points for hover
function render() {
  const d = +dsel.value, xcol = +xsel.value;
  const xs = DATA.X[xcol], ys = DATA.D[d];
  const xlo = Math.min(...xs), xhi = Math.max(...xs);
  let ylo = Math.min(...ys, 0), yhi = Math.max(...ys, 0);
  if (ylo === yhi) { ylo -= 1; yhi += 1; }
  const pad = 0.04 * (yhi - ylo); ylo -= pad; yhi += pad;
  const sx = v => M.l + (v - xlo) / (xhi - xlo || 1) * (W - M.l - M.r);
  const sy = v => H - M.b - (v - ylo) / (yhi - ylo) * (H - M.t - M.b);

  let s = `<svg viewBox="0 0 ${W} ${H}" role="img" ` +
    `aria-label="pointwise marginal effect of ${esc(DATA.dlabels[d])} vs ` +
    `${esc(DATA.xlabs[xcol])}">`;
  for (const t of niceTicks(ylo, yhi, 5)) {
    s += `<line x1="${M.l}" x2="${W - M.r}" y1="${sy(t)}" y2="${sy(t)}" ` +
         `stroke="var(--gridline)" stroke-width="1"/>` +
         `<text class="tick-label" x="${M.l - 7}" y="${sy(t) + 3.5}" ` +
         `text-anchor="end">${fmt(t, 2)}</text>`;
  }
  for (const t of niceTicks(xlo, xhi, 7)) {
    s += `<text class="tick-label" x="${sx(t)}" y="${H - M.b + 16}" ` +
         `text-anchor="middle">${fmt(t, 2)}</text>`;
  }
  s += `<line x1="${M.l}" x2="${W - M.r}" y1="${sy(0)}" y2="${sy(0)}" ` +
       `stroke="var(--baseline)" stroke-width="1.5"/>`;
  pts = [];
  for (let i = 0; i < xs.length; i++) {
    const px = sx(xs[i]), py = sy(ys[i]);
    pts.push([px, py, xs[i], ys[i]]);
    s += `<circle cx="${px.toFixed(1)}" cy="${py.toFixed(1)}" r="2.4" ` +
         `fill="var(--series-1)" fill-opacity="0.38"/>`;
  }
  if (new Set(xs).size > 2) {
    const sm = smooth(xs, ys);
    s += `<path d="M` + sm.map(p =>
      `${sx(p[0]).toFixed(1)},${sy(p[1]).toFixed(1)}`).join('L') +
      `" fill="none" stroke="var(--series-1-strong)" stroke-width="2"/>`;
  }
  s += `<text class="axis-label" x="${(M.l + W - M.r) / 2}" ` +
       `y="${H - 8}" text-anchor="middle">${esc(DATA.xlabs[xcol])}</text>`;
  s += `<text class="axis-label" transform="rotate(-90)" ` +
       `x="${-(M.t + H - M.b) / 2}" y="14" text-anchor="middle">` +
       `dy/d ${esc(DATA.dlabels[d])}</text>`;
  s += `<circle id="hl" r="4.5" fill="var(--series-1)" stroke="var(--surface-1)" ` +
       `stroke-width="2" style="display:none"/>`;
  s += '</svg>';
  chart.innerHTML = s;

  const svg = chart.querySelector('svg'), hl = chart.querySelector('#hl');
  svg.addEventListener('mousemove', ev => {
    const r = svg.getBoundingClientRect(),
          mx = (ev.clientX - r.left) * W / r.width,
          my = (ev.clientY - r.top) * H / r.height;
    let best = -1, bd = 18 * 18;
    for (let i = 0; i < pts.length; i++) {
      const dx = pts[i][0] - mx, dy = pts[i][1] - my, dd = dx * dx + dy * dy;
      if (dd < bd) { bd = dd; best = i; }
    }
    if (best < 0) { tip.style.display = 'none'; hl.style.display = 'none'; return; }
    const p = pts[best];
    hl.setAttribute('cx', p[0]); hl.setAttribute('cy', p[1]);
    hl.style.display = '';
    tip.innerHTML = `<span class="tl">${esc(DATA.xlabs[+xsel.value])}:</span> ` +
      `${fmt(p[2])}<br><span class="tl">dy/dx:</span> ${fmt(p[3])}`;
    tip.style.display = 'block';
    tip.style.left = (ev.clientX + 14) + 'px';
    tip.style.top = (ev.clientY + 14) + 'px';
  });
  svg.addEventListener('mouseleave', () => {
    tip.style.display = 'none'; hl.style.display = 'none';
  });
}

function renderTables() {
  let s = '<table><caption>Average marginal effects ' +
    `(df = ${fmt(DATA.dof, 1)})</caption>` +
    '<tr><th>variable</th><th>estimate</th><th>std. error</th>' +
    '<th>t</th><th>Pr(&gt;|t|)</th></tr>';
  DATA.ame.forEach((row, i) => {
    s += `<tr><td>${esc(DATA.dlabels[i])}</td>` +
      row.map(v => `<td>${fmt(v, 4)}</td>`).join('') + '</tr>';
  });
  s += '</table><table><caption>Percentiles of pointwise effects</caption>' +
    '<tr><th>variable</th>' +
    DATA.probs.map(q => `<th>${Math.round(q * 100)}%</th>`).join('') + '</tr>';
  DATA.pct.forEach((row, i) => {
    s += `<tr><td>${esc(DATA.dlabels[i])}</td>` +
      row.map(v => `<td>${fmt(v, 4)}</td>`).join('') + '</tr>';
  });
  s += '</table>';
  tables.innerHTML = s;
}

document.getElementById('tbl').addEventListener('click', () => {
  const showTable = tables.classList.contains('hidden');
  tables.classList.toggle('hidden', !showTable);
  chart.classList.toggle('hidden', showTable);
  document.getElementById('tbl').textContent =
    showTable ? 'chart view' : 'table view';
});
dsel.addEventListener('change', render);
xsel.addEventListener('change', render);
renderTables();
render();
</script>
</body>
</html>
"""


def effects_explorer(
    model: KRLSModel,
    path: str,
    max_points: int = _MAX_POINTS,
    seed: int = 0,
    title: Optional[str] = None,
) -> str:
    """Write a standalone interactive HTML explorer of the pointwise
    marginal effects (the Shiny-app replacement; see module docstring).

    Returns the written path.  ``max_points`` caps the embedded
    observations with a deterministic subsample (stated in the UI).
    """
    if model.derivatives is None:
        raise ValueError(
            "fit with derivative=True to explore marginal effects")
    if np.asarray(model.derivatives).shape[1] == 0:
        raise ValueError(
            "the model's derivatives matrix has zero columns "
            "(which_derivatives=[]); nothing to explore")
    which = (model.which_derivatives if model.which_derivatives is not None
             else list(range(model.p)))
    summ = _summary(model)

    n = model.n
    if n > max_points:
        idx = np.sort(np.random.default_rng(seed).choice(
            n, size=max_points, replace=False))
        subsampled = True
    else:
        idx = np.arange(n)
        subsampled = False

    X = np.asarray(model.X, dtype=np.float64)[idx]
    D = np.asarray(model.derivatives, dtype=np.float64)[idx]

    def _round(a):
        # 6 significant digits keeps the file compact at large N
        return [float(f"{v:.6g}") for v in a]

    payload = {
        "N": int(n),
        "points": int(idx.size),
        "subsampled": subsampled,
        "lambda": float(model.lambda_),
        "R2": float(model.R2),
        "R2AME": None if model.R2AME is None else float(model.R2AME),
        "dof": float(summ.n_dof - model.p),
        # RAW labels: the template escapes once per sink (textContent
        # consumes raw, innerHTML sinks run them through esc())
        "xlabs": [str(l) for l in model.xlabs],
        "dlabels": [str(l) for l in summ.labels],
        "which": [int(i) for i in which],
        "X": [_round(X[:, j]) for j in range(X.shape[1])],
        "D": [_round(D[:, d]) for d in range(D.shape[1])],
        "ame": [[float(v) for v in row] for row in summ.ttests],
        "pct": [[float(v) for v in row] for row in summ.percentiles],
        "probs": [float(q) for q in summ.probs],
    }
    # "<" is escaped so a label containing "</script>" cannot break out of
    # the inline <script> block
    doc = _TEMPLATE.replace("__PAYLOAD__",
                            json.dumps(payload).replace("<", "\\u003c"))
    tab = (title if title
           else "bigkrls_tpu_torch — marginal effects explorer")
    page = title if title else "Pointwise marginal effects"
    doc = doc.replace("__TAB_TITLE__", html.escape(tab))
    doc = doc.replace("__PAGE_TITLE__", html.escape(page))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        f.write(doc)
    return path
