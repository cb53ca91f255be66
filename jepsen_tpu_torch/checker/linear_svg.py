"""Render a failed linearizability analysis as SVG.

The reference renders ``linear.svg`` for failed analyses via
knossos.linear.report (checker.clj:207-210): a per-process timeline of
the operations around the failure, with the operation that could not be
linearized highlighted.  This is that artifact, self-contained SVG (no
graphviz): ops as horizontal bars in their [invoke, complete] windows,
the failing op in red, its concurrent ops shaded, a caption explaining
the verdict.  The port's copy of the JAX package's ``linear_svg``: the
same inputs give the same text.
"""

from __future__ import annotations

from typing import Mapping, Sequence

from jepsen_tpu_torch import history as h

BAR_H = 18
ROW_GAP = 8
LEFT = 90
WIDTH = 900
TOP = 48

TYPE_FILL = {h.OK: "#81BF67", h.INFO: "#FFA400", h.FAIL: "#FF1E90"}


def _pairs(history: Sequence[Mapping]):
    """(invoke, completion|None) pairs in invocation order, built from
    history.pair_index (the shared knossos-equivalent matcher)."""
    pair = h.pair_index(history)
    out = []
    for i, o in enumerate(history):
        if o.get("process") == h.NEMESIS or o["type"] != h.INVOKE:
            continue
        j = int(pair[i])
        out.append([o, history[j] if j >= 0 else None])
    return out


def render_failure(
    history: Sequence[Mapping],
    failing_op: Mapping | None,
    cause: str = "",
    window: int = 24,
) -> str:
    """SVG of the ops around ``failing_op`` (the op the search could not
    linearize), one row per process, failure in red, ops concurrent with
    it hatched."""
    pairs = _pairs(history)
    fail_idx = failing_op.get("index") if failing_op else None
    # Focus window: pairs whose invoke index is near the failure.
    if fail_idx is not None:
        center = next(
            (k for k, (inv, comp) in enumerate(pairs)
             if inv.get("index") == fail_idx or (comp or {}).get("index") == fail_idx),
            len(pairs) // 2,
        )
    else:
        center = len(pairs) // 2
    lo = max(0, center - window // 2)
    view = pairs[lo : lo + window]
    if not view:
        return "<svg xmlns='http://www.w3.org/2000/svg' width='10' height='10'/>"

    t0 = min(p[0].get("time", 0) for p in view)
    t1 = max(((p[1] or p[0]).get("time", 0) for p in view), default=t0 + 1)
    t1 = max(t1, t0 + 1)
    procs = sorted({p[0]["process"] for p in view}, key=str)
    rows = {p: i for i, p in enumerate(procs)}

    def px(t):
        return LEFT + (t - t0) / (t1 - t0) * (WIDTH - LEFT - 20)

    fail_inv = fail_comp = None
    for inv, comp in view:
        if fail_idx is not None and (
            inv.get("index") == fail_idx or (comp or {}).get("index") == fail_idx
        ):
            fail_inv, fail_comp = inv, comp

    height = TOP + len(procs) * (BAR_H + ROW_GAP) + 40
    e = [
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{WIDTH}" height="{height}" '
        f'font-family="Helvetica,Arial,sans-serif" font-size="11">',
        f'<rect width="{WIDTH}" height="{height}" fill="white"/>',
        f'<text x="{LEFT}" y="18" font-size="13" font-weight="bold">'
        f"linearizability failure</text>",
        f'<text x="{LEFT}" y="34" fill="#666">'
        f'{_esc(cause) or "no linearization orders this op"}</text>',
    ]
    for p, i in rows.items():
        y = TOP + i * (BAR_H + ROW_GAP)
        e.append(f'<text x="6" y="{y + BAR_H - 5}" fill="#333">proc {p}</text>')
    for inv, comp in view:
        i = rows[inv["process"]]
        y = TOP + i * (BAR_H + ROW_GAP)
        x0 = px(inv.get("time", 0))
        x1 = px((comp or inv).get("time", 0)) if comp else px(t1)
        x1 = max(x1, x0 + 3)
        is_fail = fail_inv is inv
        concurrent = (
            fail_inv is not None
            and not is_fail
            and inv.get("time", 0) <= (fail_comp or {"time": t1}).get("time", t1)
            and (comp or {"time": t1}).get("time", t1) >= fail_inv.get("time", 0)
        )
        fill = "#D0021B" if is_fail else TYPE_FILL.get((comp or {}).get("type"), "#BBB")
        opacity = "1.0" if is_fail else ("0.9" if concurrent else "0.45")
        e.append(
            f'<rect x="{x0:.1f}" y="{y}" width="{x1 - x0:.1f}" height="{BAR_H}" '
            f'rx="3" fill="{fill}" fill-opacity="{opacity}"'
            + (' stroke="#900" stroke-width="2"' if is_fail else "")
            + "/>"
        )
        label = f"{inv.get('f')} {inv.get('value')!r}"
        if comp and comp.get("value") != inv.get("value"):
            label += f" → {comp.get('value')!r}"
        e.append(
            f'<text x="{x0 + 3:.1f}" y="{y + BAR_H - 5}" fill="#111" '
            f'font-size="10">{_esc(label[:48])}</text>'
        )
    e.append(
        f'<text x="{LEFT}" y="{height - 10}" fill="#666">red = op with no legal '
        f"linearization; saturated = concurrent with it; type colors: "
        f"ok green / info orange / fail pink</text>"
    )
    e.append("</svg>")
    return "\n".join(e)


def _esc(s: str) -> str:
    return s.replace("&", "&amp;").replace("<", "&lt;").replace(">", "&gt;")
