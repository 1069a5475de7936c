"""Self-contained interactive HTML exports (tanglegram + network).

The reference renders its tanglegram as chromoMap htmlwidgets
(R/createTanglegram.R:278-293) and its networks via igraph/ggraph
(R/createNetworkPlot.R) — interactive artifacts a browser can explore.
The matplotlib PNGs this package produces are equivalent static views;
this module closes the interactivity gap with ZERO-dependency HTML files:
inline SVG + a small hand-written script (no CDN, works offline), hover
tooltips, and click-to-highlight for links.

Both writers are called from the same code paths that emit the PNGs, and
run whether or not matplotlib is installed: the PNGs are skipped without
it, the HTML pages are not.
"""

from __future__ import annotations

import html
from typing import Callable, List

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 1rem; }}
 h2 {{ font-size: 1.05rem; }}
 .lbl {{ font-size: 9px; fill: #333; cursor: default; }}
 .link {{ stroke: #0868ac; stroke-width: 1; opacity: 0.45; cursor: pointer; }}
 .link.hi {{ stroke: #db4325; stroke-width: 2.5; opacity: 1; }}
 .node {{ fill: #db4325; cursor: pointer; }}
 .node.hi {{ fill: #0868ac; }}
 #tip {{ position: fixed; background: #222; color: #fff; padding: 4px 8px;
        border-radius: 4px; font-size: 11px; pointer-events: none;
        visibility: hidden; z-index: 10; }}
</style></head><body>
<h2>{title}</h2>
<div id="tip"></div>
{svg}
<script>
const tip = document.getElementById('tip');
function showTip(e, text) {{
  tip.textContent = text; tip.style.visibility = 'visible';
  tip.style.left = (e.clientX + 12) + 'px';
  tip.style.top = (e.clientY + 12) + 'px';
}}
function hideTip() {{ tip.style.visibility = 'hidden'; }}
document.querySelectorAll('[data-tip]').forEach(el => {{
  el.addEventListener('mousemove', e => showTip(e, el.dataset.tip));
  el.addEventListener('mouseleave', hideTip);
}});
document.querySelectorAll('.link').forEach(el => {{
  el.addEventListener('click', () => el.classList.toggle('hi'));
}});
document.querySelectorAll('.node').forEach(el => {{
  el.addEventListener('click', () => {{
    const id = el.dataset.node;
    document.querySelectorAll('.link').forEach(l => {{
      if (l.dataset.a === id || l.dataset.b === id) l.classList.toggle('hi');
    }});
  }});
}});
</script></body></html>
"""


def _esc(s) -> str:
    return html.escape(str(s), quote=True)


def write_tanglegram_html(
    pos1: np.ndarray,
    pos2: np.ndarray,
    mi: np.ndarray,
    segs: np.ndarray,
    locus_name: Callable[[int], str],
    path: str,
    links_type: str = "SR",
) -> None:
    """One interactive two-track tanglegram panel per segment (the
    chromoMap-equivalent artifact, R/createTanglegram.R:278-293)."""
    W, H, PAD = 900, 170, 40
    panels = []
    for s in np.unique(segs):
        sel = segs == s
        p1, p2, m = pos1[sel], pos2[sel], mi[sel]
        lo = int(min(p1.min(), p2.min()))
        hi = int(max(p1.max(), p2.max()))
        span = max(1, hi - lo)

        def x(p):
            return PAD + (int(p) - lo) / span * (W - 2 * PAD)

        parts = [
            f'<svg width="{W}" height="{H}" '
            f'xmlns="http://www.w3.org/2000/svg">',
            f'<text x="{PAD}" y="14" class="lbl">segment {int(s)}: '
            f"{lo:,} - {hi:,}</text>",
            f'<line x1="{PAD}" y1="40" x2="{W - PAD}" y2="40" '
            'stroke="#bbb"/>',
            f'<line x1="{PAD}" y1="{H - 40}" x2="{W - PAD}" y2="{H - 40}" '
            'stroke="#bbb"/>',
        ]
        for a, b, v in zip(p1, p2, m):
            parts.append(
                f'<line class="link" data-a="p{int(a)}" data-b="p{int(b)}" '
                f'x1="{x(a):.1f}" y1="40" x2="{x(b):.1f}" y2="{H - 40}" '
                f'data-tip="{_esc(locus_name(int(a)))} ({int(a):,}) — '
                f'{_esc(locus_name(int(b)))} ({int(b):,}) | MI {v:.4g}"/>'
            )
        for p, y in [(p1, 40), (p2, H - 40)]:
            for pp in np.unique(p):
                parts.append(
                    f'<circle class="node" data-node="p{int(pp)}" '
                    f'cx="{x(pp):.1f}" cy="{y}" r="3.5" '
                    f'data-tip="{_esc(locus_name(int(pp)))} ({int(pp):,})"/>'
                )
        parts.append("</svg>")
        panels.append("".join(parts))
    with open(path, "wt") as fh:
        fh.write(
            _PAGE.format(
                title=f"{links_type} tanglegram ({len(panels)} segments)",
                svg="\n".join(panels),
            )
        )


def write_network_html(
    gene1: List[str],
    gene2: List[str],
    weight: np.ndarray,
    path: str,
    title: str = "GWES network",
) -> None:
    """Interactive circular-layout gene network (igraph/ggraph-equivalent
    artifact, R/createNetworkPlot.R:28-144): nodes on a circle, chords for
    links, hover weights, click-to-highlight incident links."""
    genes = sorted(set(gene1) | set(gene2))
    n = max(1, len(genes))
    W = 760
    cx = cy = W / 2
    R = W / 2 - 110
    ang = {
        g: 2 * np.pi * i / n - np.pi / 2 for i, g in enumerate(genes)
    }

    def xy(g):
        return cx + R * np.cos(ang[g]), cy + R * np.sin(ang[g])

    parts = [f'<svg width="{W}" height="{W}" '
             f'xmlns="http://www.w3.org/2000/svg">']
    wmax = float(np.max(weight)) if len(weight) else 1.0
    for a, b, v in zip(gene1, gene2, weight):
        x1, y1 = xy(a)
        x2, y2 = xy(b)
        lw = 0.8 + 2.5 * float(v) / max(wmax, 1e-12)
        parts.append(
            f'<path class="link" data-a="g{_esc(a)}" data-b="g{_esc(b)}" '
            f'd="M{x1:.1f},{y1:.1f} Q{cx:.1f},{cy:.1f} {x2:.1f},{y2:.1f}" '
            f'fill="none" style="stroke-width:{lw:.2f}" '
            f'data-tip="{_esc(a)} — {_esc(b)} | weight {v:.4g}"/>'
        )
    for g in genes:
        x, y = xy(g)
        deg = np.degrees(ang[g])
        flip = 90 < (deg % 360) < 270
        tx = x + (np.cos(ang[g]) * 8)
        ty = y + (np.sin(ang[g]) * 8)
        anchor = "end" if flip else "start"
        rot = deg + 180 if flip else deg
        parts.append(
            f'<circle class="node" data-node="g{_esc(g)}" '
            f'cx="{x:.1f}" cy="{y:.1f}" r="4" data-tip="{_esc(g)}"/>'
            f'<text class="lbl" x="{tx:.1f}" y="{ty:.1f}" '
            f'text-anchor="{anchor}" '
            f'transform="rotate({rot:.1f} {tx:.1f} {ty:.1f})">'
            f"{_esc(g)}</text>"
        )
    parts.append("</svg>")
    with open(path, "wt") as fh:
        fh.write(_PAGE.format(title=_esc(title), svg="".join(parts)))
