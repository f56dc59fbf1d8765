"""The port's genotype figures (fasterseg_tpu_torch/utils/plotting.py), the
metric writer's figures, and `run_search(plot_genotypes=True)`, against the
JAX package's utils/plotting.py on the shipped genotypes.

* `plot_op`: the table's every cell (op name, 1/scale, w=) and the figure's
  size equal the JAX function's, read from the two figures.
* `plot_path_width`: every line's points, width (1 + 4 w), colour and label,
  and the axes' ticks and labels equal the JAX function's.
* `MetricWriter.add_figure` writes `<tag, / as _>_<step>.png`.
* A tiny search epoch with `plot_genotypes` writes the JAX loop's tags
  (`arch/ops{last}_{name}`, `arch/path_width_{name}`) for both archs.
"""

import os

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from fasterseg_tpu.core import ArchParams as JaxArchParams  # noqa: E402
from fasterseg_tpu.core.genotype import decode_network as jax_decode  # noqa
from fasterseg_tpu.utils import plotting as jax_plotting  # noqa: E402
from fasterseg_tpu_torch.core import ArchParams  # noqa: E402
from fasterseg_tpu_torch.core.config import WIDTH_MULT_LIST  # noqa: E402
from fasterseg_tpu_torch.core.genotype import decode_network  # noqa: E402
from fasterseg_tpu_torch.utils import plotting  # noqa: E402
from fasterseg_tpu_torch.utils.logging import MetricWriter  # noqa: E402

from _torch_search_common import (HW, few_threads, port_lut,  # noqa: E402
                                  tiny_configs)

ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def _genotypes(idx: int):
    """The shipped arch's decoded branches, by each package."""
    path = os.path.join(ASSETS, f"arch_{idx}.npz")
    ours = decode_network(ArchParams.from_npz(path), WIDTH_MULT_LIST, 16,
                          ignore_skip=idx == 0)
    theirs = jax_decode(JaxArchParams.from_npz(path), WIDTH_MULT_LIST, 16,
                        ignore_skip=idx == 0)
    return ours, theirs


def _cells(fig):
    table = fig.axes[0].tables[0]
    return {k: c.get_text().get_text() for k, c in table.get_celld().items()}


def test_op_short_names_every_primitive():
    from fasterseg_tpu_torch.core.genotype import PRIMITIVES
    assert plotting.OP_SHORT == jax_plotting.OP_SHORT
    assert sorted(plotting.OP_SHORT) == list(range(len(PRIMITIVES)))


@pytest.mark.parametrize("idx", [0, 1])
@pytest.mark.parametrize("with_widths", [True, False])
def test_plot_op_matches_jax(idx, with_widths):
    ours, theirs = _genotypes(idx)
    for last in ours:
        g, j = ours[last], theirs[last]
        widths = (g.widths, j.widths) if with_widths else (None, None)
        a = plotting.plot_op(g.ops, g.path, widths[0])
        b = jax_plotting.plot_op(j.ops, j.path, widths[1], F_base=12)
        try:
            cells = _cells(a)
            assert cells == _cells(b)
            assert len(cells) == 2 * len(g.ops)
            assert tuple(a.get_size_inches()) == tuple(b.get_size_inches())
        finally:
            plt.close(a)
            plt.close(b)


def test_plot_op_head_width_past_the_widths():
    """A cell past the last width shows `head_width`, as the JAX
    function's does."""
    a = plotting.plot_op([1, 2, 3], [0, 0, 1], [0.5, 0.75], head_width=0.25)
    b = jax_plotting.plot_op([1, 2, 3], [0, 0, 1], [0.5, 0.75],
                             head_width=0.25)
    try:
        assert _cells(a) == _cells(b)
        assert "w=0.25" in _cells(a)[(1, 2)]
    finally:
        plt.close(a)
        plt.close(b)


def _lines(fig):
    ax = fig.axes[0]
    return [(tuple(map(float, l.get_xdata())), tuple(map(float,
                                                         l.get_ydata())),
             l.get_linewidth(), l.get_color(), l.get_label())
            for l in ax.get_lines()]


@pytest.mark.parametrize("idx", [0, 1])
def test_plot_path_width_matches_jax(idx):
    ours, theirs = _genotypes(idx)
    order = (2, 1, 0)
    a = plotting.plot_path_width(list(order),
                                 [ours[b].path for b in order],
                                 [ours[b].widths for b in order])
    b = jax_plotting.plot_path_width(list(order),
                                     [theirs[k].path for k in order],
                                     [theirs[k].widths for k in order])
    try:
        lines = _lines(a)
        assert lines == _lines(b)
        # one segment a layer step of each branch, 1 + 4 w wide
        assert len(lines) == sum(len(ours[k].path) - 1 for k in order)
        first = [l for l in lines if not l[4].startswith("_")]
        assert [l[4] for l in first] == ["1/32", "1/16", "1/8"]
        g = ours[2]
        assert first[0][2] == pytest.approx(1 + 4 * g.widths[0])
        ax, bx = a.axes[0], b.axes[0]
        assert list(ax.get_yticks()) == list(bx.get_yticks()) == [0, -1, -2]
        assert ([t.get_text() for t in ax.get_yticklabels()]
                == [t.get_text() for t in bx.get_yticklabels()]
                == ["1/8", "1/16", "1/32"])
        assert ax.get_xlabel() == bx.get_xlabel() == "layer"
    finally:
        plt.close(a)
        plt.close(b)


def test_add_figure_writes_its_png(tmp_path):
    writer = MetricWriter(str(tmp_path), tensorboard=False)
    ours, _ = _genotypes(1)
    fig = plotting.plot_op(ours[1].ops, ours[1].path, ours[1].widths)
    try:
        writer.add_figure("arch/ops1_student", fig, 3)
        writer.add_image("arch/image", np.zeros((4, 5, 3), np.uint8), 3)
    finally:
        plt.close(fig)
        writer.close()
    path = tmp_path / "arch_ops1_student_3.png"
    with open(path, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert sorted(os.listdir(tmp_path)) == ["arch_ops1_student_3.png",
                                            "metrics.jsonl"]


def test_run_search_plots_the_genotypes(tmp_path):
    """One search epoch of one step at the tiny configuration: every JAX
    tag's figure, for the teacher and the student."""
    from fasterseg_tpu_torch.data import SyntheticDataset
    from fasterseg_tpu_torch.search import run_search
    cfg, _ = tiny_configs(pretrain=False)
    run_search(cfg, val_dataset=SyntheticDataset(length=1, hw=HW,
                                                 num_classes=19),
               epochs=1, niters=1, max_eval_items=1, save_dir=str(tmp_path),
               lut=port_lut(), plot_genotypes=True, device="cpu")
    want = {f"arch_{kind}_{name}_0.png" for name in ("teacher", "student")
            for kind in ("ops0", "ops1", "ops2", "path_width")}
    got = {f for f in os.listdir(tmp_path) if f.endswith(".png")}
    assert got == want
    for f in want:
        assert os.path.getsize(tmp_path / f) > 1000
    assert not plt.get_fignums()      # every figure was closed
