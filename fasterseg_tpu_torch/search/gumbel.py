"""Gumbel-softmax sampling and width-ratio sampling.

Counterparts of the JAX package's search/gumbel.py: the reference's
straight-through Gumbel (search/model_search.py:14-43) and
`sample_prun_ratio` (model_search.py:209-261). A width sample is an
(index, score) pair per layer: the index (int64, on the device) selects
channel masks and BN rows, and the score carries the straight-through
gradient (the hard sample's largest entry: value 1, gradient that of the
soft sample), the r_score the reference multiplies into its MixedOp
outputs (model_search.py:60-78).

The random draws are explicit: each function takes its uniform noise (or,
for 'random', its indices) as an optional argument beside a
`torch.Generator`, so the draws can be made on the host, fed from another
implementation in tests, or replayed.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

RatioSample = Tuple[torch.Tensor, torch.Tensor]


def _uniform(shape, like: torch.Tensor,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """U[0, 1) drawn from `generator` (on its own device, the CPU by
    default) and moved to `like`'s device."""
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=generator.device if generator is not None
                   else "cpu")
    return u.to(like.device)


def sample_gumbel(shape, like: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  uniform: Optional[torch.Tensor] = None,
                  eps: float = 1e-20) -> torch.Tensor:
    """Gumbel(0, 1) noise -log(-log(u + eps) + eps)."""
    u = _uniform(shape, like, generator) if uniform is None \
        else uniform.to(device=like.device, dtype=like.dtype)
    return -torch.log(-torch.log(u + eps) + eps)


def gumbel_softmax(logits: torch.Tensor, temperature: float = 1.0,
                   hard: bool = False,
                   generator: Optional[torch.Generator] = None,
                   uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Straight-through Gumbel-softmax (model_search.py:25-43)."""
    y = torch.softmax((logits + sample_gumbel(logits.shape, logits, generator,
                                              uniform)) / temperature, -1)
    if not hard:
        return y
    y_hard = torch.nn.functional.one_hot(torch.argmax(y, -1),
                                         logits.shape[-1]).to(y.dtype)
    return (y_hard - y).detach() + y


def _st_sample(logits: torch.Tensor, uniform) -> RatioSample:
    y = gumbel_softmax(torch.log_softmax(logits, -1), hard=True,
                       uniform=uniform)
    idx = torch.argmax(y.detach(), -1)
    score = torch.max(y, -1).values  # value 1, gradient to the logits
    return idx, score


def draw_noise(ratio_logits: Sequence[torch.Tensor], mode: str,
               num_widths: int, generator: Optional[torch.Generator] = None
               ) -> List[Optional[torch.Tensor]]:
    """The random draws `sample_ratios` needs for `mode`, one entry a scale,
    on the host: uniforms for 'arch_ratio', int64 indices for 'random',
    None otherwise."""
    out: List[Optional[torch.Tensor]] = []
    for logits in ratio_logits:
        if mode == "arch_ratio":
            out.append(torch.rand(tuple(logits.shape), generator=generator,
                                  dtype=logits.dtype))
        elif mode == "random":
            out.append(torch.randint(0, num_widths, (logits.shape[0],),
                                     generator=generator))
        elif mode in ("min", "max"):
            out.append(None)
        else:
            raise ValueError(mode)
    return out


def sample_ratios(ratio_logits: Sequence[torch.Tensor], mode: str,
                  num_widths: int,
                  generator: Optional[torch.Generator] = None,
                  noise: Optional[Sequence[Optional[torch.Tensor]]] = None
                  ) -> List[RatioSample]:
    """Per-layer width samples of the three scales (model_search.py:
    209-261). Modes:
      arch_ratio  straight-through Gumbel over the log-softmax logits
      min / max   the smallest / largest width
      random      a uniform choice of width (the pretrain sandwich rule)

    `noise` (from `draw_noise`, or another implementation's draws) replaces
    drawing from `generator`. Indices refer to the global width list; 'max'
    is its last entry even where the arch's ratio logits are 1 wide (teacher
    search with prun_mode 'max', model_search.py:523-527).
    """
    if noise is None:
        noise = draw_noise(ratio_logits, mode, num_widths, generator)
    out: List[RatioSample] = []
    for logits, draw in zip(ratio_logits, noise):
        n, dev = logits.shape[0], logits.device
        ones = torch.ones(n, dtype=logits.dtype, device=dev)
        if mode == "arch_ratio":
            idx, score = _st_sample(logits, draw)
            if logits.shape[-1] == 1:
                # 1-wide ratio logits: argmax is 0; remap to the max width
                idx = torch.full((n,), num_widths - 1, dtype=torch.int64,
                                 device=dev)
            out.append((idx, score))
        elif mode == "min":
            out.append((torch.zeros(n, dtype=torch.int64, device=dev), ones))
        elif mode == "max":
            out.append((torch.full((n,), num_widths - 1, dtype=torch.int64,
                                   device=dev), ones))
        elif mode == "random":
            out.append((draw.to(device=dev, dtype=torch.int64), ones))
        else:
            raise ValueError(mode)
    return out
