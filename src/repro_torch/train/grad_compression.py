"""int8 error-feedback gradient compression for the data-parallel reduce.

Counterpart of `repro.train.grad_compression`, with its arithmetic in its
order. A two-phase compressed all-reduce (the 1-bit Adam family, here 8
bits):

  1. quantize the local gradients to int8 with one fp32 scale, carrying the
     quantization residual into the next step (error feedback keeps the
     convergence);
  2. all-to-all the int8 chunks over the data axis (1 byte per element);
  3. dequantize locally and take the fp32 mean of the received chunks;
  4. requantize the reduced chunk and all-gather it as int8 (1 byte per
     element).

On the wire that is 2 x 1 byte per element against 2 x 2 for a bf16 ring
all-reduce (4 for fp32). Under gloo with the ranks on one card the
all-to-all and the all-gather are all-reduces of zero-padded buffers
(`launch/mesh.py`), so one card shows no wire saving.

The scale is max(max|x|, 1e-30) times the fp32 1/127, as XLA compiles the
reference's division by the constant 127; values round half to even and
clip to +-127. The peers' chunks are summed as XLA sums the reference's
einsum (`_peer_sum`), so the collective version and the single-process
plain version (`plain_compressed_mean`) give the same bytes on any device. A tree is
quantized, and its residual taken, per leaf of the reference's stacked tree
(a layer stack's leaf has one scale over its layers), and concatenated in
the reference's flatten order.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.distributed.data_parallel import local_batch
from repro_torch.optim import no_frozen
from repro_torch.train.train_step import grads_tree, trainable_view
from repro_torch.weights import flat_vector, reference_leaves, tree_map_ref, unflatten_vector

# the fp32 1/127 (XLA turns the reference's x / 127.0 into x * this)
INV_127 = float(np.float32(1.0 / 127.0))
# elements per float64 slice of the peer sum: bounds its temporaries
PEER_SUM_SLICE = 1 << 24


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax.float(), 1e-30) * INV_127


def _absmax(x: torch.Tensor) -> torch.Tensor:
    """max|x| without an |x| temporary the size of x."""
    lo, hi = torch.aminmax(x)
    return torch.maximum(-lo, hi)


def _to_int8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return (x / scale).round_().clamp_(-127, 127).to(torch.int8)


def _quant(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 values, fp32 0-d scale) of `x`."""
    scale = _scale(_absmax(x))
    return _to_int8(x, scale), scale


def _peer_sum(recv: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """sum_p recv[p] * scales[p] / n as XLA computes the reference's einsum:
    fused multiply-adds in peer order (each one exact in float64, then
    rounded to fp32), then times the fp32 1/n; in slices of PEER_SUM_SLICE
    elements."""
    n = recv.shape[0]
    s64 = scales.double()
    flat = recv.reshape(n, -1)
    out = torch.empty(flat.shape[1], dtype=torch.float32, device=recv.device)
    for a in range(0, out.numel(), PEER_SUM_SLICE):
        b = min(a + PEER_SUM_SLICE, out.numel())
        acc = torch.zeros(b - a, dtype=torch.float32, device=recv.device)
        for p in range(n):
            acc = (acc.double() + flat[p, a:b].double() * s64[p]).float()
        out[a:b] = acc
    return out.mul_(float(np.float32(1.0 / n))).reshape(recv.shape[1:])


def compressed_mean_1d(vec: torch.Tensor, mesh) -> torch.Tensor:
    """The mean over `mesh`'s data ranks of a flat fp32 vector whose length
    divides by their number; every rank calls it with its own `vec` and
    gets the same result. Both wire phases move int8."""
    n = mesh.data
    q, s = _quant(vec.reshape(n, -1))
    recv = mesh.all_to_all(q)                          # row p: peer p's chunk for my slot
    scales = mesh.all_gather(s.reshape(1)).reshape(n)  # the peers' scales
    q2, s2 = _quant(_peer_sum(recv, scales))
    all_q = mesh.all_gather(q2)                        # (n, chunk) int8
    all_s = mesh.all_gather(s2.reshape(1))             # (n, 1)
    return all_q.float().mul_(all_s).reshape(-1)


def plain_compressed_mean(vecs: torch.Tensor) -> torch.Tensor:
    """What every rank of `compressed_mean_1d` ends with, in one process:
    `vecs` (n, L) holds rank r's vector in row r."""
    n = vecs.shape[0]
    qs, ss = zip(*(_quant(v.reshape(n, -1)) for v in vecs))
    q, s = torch.stack(qs), torch.stack(ss)            # q: [sender, slot, chunk]
    out_q, out_s = zip(*(_quant(_peer_sum(q[:, r], s)) for r in range(n)))
    return torch.stack(out_q).float().mul_(torch.stack(out_s).reshape(n, 1)).reshape(-1)


def compressed_mean_tree(grads: Any, mesh) -> Any:
    """`compressed_mean_1d` of the whole tree at once (zero-padded to a
    multiple of the ranks), cut back into the tree."""
    vec = flat_vector(grads)
    size, pad = vec.numel(), (-vec.numel()) % mesh.data
    if pad:
        vec = torch.nn.functional.pad(vec, (0, pad))
    return unflatten_vector(compressed_mean_1d(vec, mesh)[:size], grads)


def plain_compressed_mean_tree(trees: list) -> Any:
    """What every rank of `compressed_mean_tree` ends with, in one process:
    `trees[r]` is rank r's tree."""
    vecs = torch.stack([flat_vector(t) for t in trees])
    pad = (-vecs.shape[1]) % len(trees)
    out = plain_compressed_mean(torch.nn.functional.pad(vecs, (0, pad)))
    return unflatten_vector(out[:vecs.shape[1]], trees[0])


def residual_correct(grads: Any, residual: Any) -> tuple[Any, Any]:
    """Error feedback: add the carried residual; returns (corrected, new
    residual), the residual being exactly what int8 drops of each leaf."""
    corrected = tree_map_ref(lambda _p, g, r: g.float() + r, grads, residual)
    scales = {p: _scale(torch.stack([_absmax(leaf) for leaf in leaves]).max())
              for p, leaves in reference_leaves(corrected).items()}
    new_residual = tree_map_ref(
        lambda p, c: c - _to_int8(c, scales[p]).float().mul_(scales[p]), corrected)
    return corrected, new_residual


def init_residual(params: Any) -> Any:
    return tree_map_ref(lambda _p, p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)


def make_compressed_grad_fn(loss_fn: Callable[[Any, Any], torch.Tensor], mesh, *,
                            axis: str = "data") -> Callable:
    """Data-parallel value-and-grad with the int8 compressed reduce over
    `mesh`'s data ranks. Returns step(params, residual, batch) -> (mean loss,
    mean grads, new residual): params replicated, each rank taking its rows
    of the global batch (`local_batch`)."""
    if axis != "data":
        raise ValueError(f"the port's meshes reduce gradients over 'data', not {axis!r}")

    def step(params, residual, batch):
        live, leaves = trainable_view(params, no_frozen(params))
        loss = loss_fn(live, local_batch(batch, mesh))
        grads = grads_tree(loss, leaves, params, no_frozen(params))
        corrected, new_residual = residual_correct(grads, residual)
        reduced = compressed_mean_tree(corrected, mesh)
        loss = mesh.all_mean(loss.detach().float().reshape(1))[0]
        return loss, reduced, new_residual

    return step
