"""Boosting and global inhibition (reference `regularizations.py:4-29`),
counterpart of `bithtm_tpu/ops/regularization.py`.

`sp_select` is the SP's column selection of a step (the boost, the top-A
inhibition and the duty-cycle EMA): the CUDA kernel of the same name
(`ops/kernels.py`, `csrc/select_pass.cu`) on the card, and on the CPU its
plain version `sp_select_ref`, the chain of `boost`, `k_winners` and
`duty_cycle_update`."""

from __future__ import annotations

import numpy as np
import torch

from .active_set import _on_device, column_mask_from_cols


def boost_factor(duty_cycle: torch.Tensor, intensity: float,
                 density: float) -> torch.Tensor:
    """exp(-(intensity / density) * duty_cycle), float32. The argument is
    rounded to float32 as the JAX package rounds it; the exponential is
    taken in float64 and rounded once to float32, so the CPU and the card
    give the same factor (their float32 `exp`s differ by 1 ulp on about
    three factors in ten and by 2 on some, ROADMAP.md fault k). The
    rounded value lies within 1 ulp of any float32 `exp` accurate to
    1 ulp, so it keeps the 1-ulp agreement with the JAX package.

    On the CPU the float64 `exp` is numpy's and not ATen's: two CPU
    calls of ATen's on the same input once gave 18 of 16,384 factors
    1 ulp apart under the test runner, for a cause not yet found
    (ROADMAP.md fault g). numpy runs a ufunc on the calling thread (in
    its own SIMD loops), so its result does not depend on the process's
    thread count or how ATen splits the work. The card keeps
    `torch.exp` in float64 (fault k: 0 ulp against the CPU)."""
    arg = -(intensity / density) * duty_cycle
    if arg.device.type == "cpu":
        exact = np.exp(arg.detach().numpy().astype(np.float64))
        return torch.from_numpy(exact.astype(np.float32))
    return torch.exp(arg.double()).float()


def boost(overlaps: torch.Tensor, duty_cycle: torch.Tensor,
          intensity: float, density: float) -> torch.Tensor:
    """Boosted overlaps (f32). XLA's `exp` may differ from the correctly
    rounded factor by one ulp, so the boost factor agrees with the JAX
    package within 1 ulp and the boosted overlap, rounded once more by
    the product, within 2 ulp (ROADMAP.md, fault g)."""
    return boost_factor(duty_cycle, intensity, density) * overlaps.to(
        torch.float32)


def _fma_f32(a: torch.Tensor, b: float, c: torch.Tensor) -> torch.Tensor:
    """a * b + c for float32 tensors, rounded once, as a fused
    multiply-add rounds it. The product of two f32 values is exact in
    f64; the f64 sum is rounded to odd (TwoSum error term, then the last
    bit forced to 1 where inexact), which makes the final rounding to
    f32 the correct single rounding."""
    p = a.double() * float(torch.tensor(b, dtype=torch.float32))
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def duty_cycle_update(duty_cycle: torch.Tensor, active_mask: torch.Tensor,
                      momentum: float) -> torch.Tensor:
    """EMA of column activity, updated every step whether or not the
    model learns (reference `networks.py:33`). XLA contracts the JAX
    package's ``duty * momentum + mask * (1 - momentum)`` into one fused
    multiply-add when it compiles the step, so the port rounds it once
    too (`_fma_f32`); two roundings differ in the last bit on about one
    value in seven."""
    return _fma_f32(duty_cycle, momentum,
                    active_mask.to(torch.float32) * (1.0 - momentum))


def k_winners(boosted: torch.Tensor, k: int):
    """Global inhibition: exact top-k along the last axis, ties to the
    lowest index (as `jax.lax.top_k`), through a stable descending sort;
    `torch.topk` promises no tie order. Returns ((..., k) int32 indices
    in descending value order, (..., C) bool mask)."""
    idx = torch.sort(boosted, dim=-1, descending=True,
                     stable=True).indices[..., :k].to(torch.int32)
    return idx, column_mask_from_cols(idx, boosted.shape[-1])


def select_scalars(intensity: float, density: float, momentum: float
                   ) -> tuple[float, float, float]:
    """The float32 scalars of `sp_select_ref`'s chain: -(intensity /
    density), the momentum and 1 - momentum, each taken in Python and
    rounded once to float32, as torch rounds a Python scalar against a
    float32 tensor."""
    return tuple(float(np.float32(v)) for v in (
        -(intensity / density), momentum, 1.0 - momentum))


def sp_select_ref(overlaps: torch.Tensor, duty_cycle: torch.Tensor, k: int,
                  intensity: float, density: float, momentum: float
                  ) -> tuple[torch.Tensor, ...]:
    """Plain version of the `sp_select` kernel: the (B, C) boosted
    overlaps (`boost`), the ``k`` winners (B, k) int32 in descending value
    order and their (B, C) bool mask (`k_winners`), and the new (B, C)
    duty cycles (`duty_cycle_update`)."""
    boosted = boost(overlaps, duty_cycle, intensity, density)
    cols, mask = k_winners(boosted, k)
    return boosted, cols, mask, duty_cycle_update(duty_cycle, mask,
                                                  momentum)


def sp_select(overlaps: torch.Tensor, duty_cycle: torch.Tensor, k: int,
              intensity: float, density: float, momentum: float
              ) -> tuple[torch.Tensor, ...]:
    """The SP's column selection of a step, (boosted, columns, mask, new
    duty cycles): the `sp_select` kernel for CUDA tensors, the plain
    version for CPU tensors (arguments and results as
    `sp_select_ref`'s). The state's duty cycles are not written."""
    if _on_device("sp_select", overlaps) == "cuda":
        from .kernels import sp_select_cuda

        return sp_select_cuda(overlaps.contiguous(), duty_cycle.contiguous(),
                              k, *select_scalars(intensity, density,
                                                 momentum))
    return sp_select_ref(overlaps, duty_cycle, k, intensity, density,
                         momentum)
