"""Genotype figures: op tables and path/width plots.

Counterpart of the JAX package's utils/plotting.py (the reference's
tools/utils/darts_utils.py `plot_op` :308-341 and `plot_path_width`
:256-306): a decoded architecture drawn as (a) a table of its cells' ops,
scales and widths and (b) its downsampling path, with line widths that grow
with the channel width. matplotlib is imported inside the calls (with the
Agg backend), so importing this module needs no matplotlib.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from ..core.genotype import PRIMITIVES

# a short name for each primitive, in PRIMITIVES' order
OP_SHORT = dict(enumerate(("skip", "conv", "conv-zoom", "conv2x",
                           "conv2x-zoom")[:len(PRIMITIVES)]))


def plot_op(ops: Sequence[int], path: Sequence[int],
            widths: Sequence[float] = None, head_width: float = None):
    """Table figure: one column a cell with its op's name, its scale and,
    with `widths`, its width multiplier (`head_width` past the last width).
    (The JAX function also takes `F_base` for a filter count it computes
    and never shows.)"""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = len(ops)
    assert len(path) == n
    table = []
    for i in range(n):
        scale = 2 ** (path[i] + 3)
        if widths is not None:
            w = widths[i] if i < len(widths) else (head_width or 1.0)
            cell = f"{OP_SHORT[ops[i]]}\n1/{scale}\nw={w:.2f}"
        else:
            cell = f"{OP_SHORT[ops[i]]}\n1/{scale}"
        table.append(cell)
    fig, ax = plt.subplots(figsize=(max(6, n * 0.9), 1.6))
    ax.axis("off")
    tb = ax.table(cellText=[table],
                  colLabels=[str(i) for i in range(n)], loc="center",
                  cellLoc="center")
    tb.auto_set_font_size(False)
    tb.set_fontsize(7)
    tb.scale(1, 2.2)
    return fig


def plot_path_width(lasts: Sequence[int], paths: Sequence[Sequence[int]],
                    widths: Sequence[Sequence[float]]):
    """Downsampling-path plot, one line a branch; each segment's line
    width is 1 + 4 w for the width multiplier w of the cell it leaves
    (darts_utils.py:256-306)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 2.5))
    colors = ["tab:blue", "tab:orange", "tab:green"]
    for b, (last, path) in enumerate(zip(lasts, paths)):
        ws = list(widths[b]) + [widths[b][-1] if len(widths[b]) else 1.0]
        x = np.arange(len(path))
        y = -np.asarray(path, float) - b * 0.06  # a small offset a branch
        for i in range(len(path) - 1):
            ax.plot(x[i:i + 2], y[i:i + 2], color=colors[b % 3],
                    linewidth=1 + 4 * ws[i],
                    label=f"1/{2 ** (last + 3)}" if i == 0 else None)
    ax.set_yticks([0, -1, -2])
    ax.set_yticklabels(["1/8", "1/16", "1/32"])
    ax.set_xlabel("layer")
    ax.legend(loc="lower left", fontsize=7)
    fig.tight_layout()
    return fig
