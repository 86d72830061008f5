"""The training step: loss -> gradients (torch.autograd) -> global-norm
clip -> AdamW with param groups -> new params, optimizer state and metrics.

Counterpart of `repro.train.train_step`. Loss variants (recipe stages):
  * plain cross-entropy (dense pretrain, soft-PQ fine-tune);
  * distillation (`DistillSpec` + a frozen dense teacher):
    (1-w)·CE + w·τ²·KL(teacher‖student) over τ-softened logits; the metrics
    then also report `ce` and `distill_kl`.

The metrics carry the learned temperature, `t_mean`/`t_min` over every
`log_t` leaf, when the tree has LUT sites. Gradient accumulation runs the
microbatches one after the other, so only one microbatch's activations are
live, and sums their gradients in fp32.

Frozen leaves (the dense weights of LUT sites) take no gradient: only the
other leaves are handed to autograd, as fresh views with requires_grad, so
the caller's tensors are never changed.

`make_compressed_train_step` is the opt-in data-parallel variant wiring
`train.grad_compression` (the int8 error-feedback reduce) under the same
(params, state, batch) step contract: the compression residual rides in the
opaque optimizer-state slot, so the Trainer checkpoints and restores it
with no special case. The exact data-parallel step with ZeRO-1 moments is
`distributed.data_parallel.make_data_parallel_step`. `make_serve_step` is
`ModelBundle.forward_step` under the step contract.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.optim import AdamW, AdamWState, no_frozen
from repro_torch.weights import tree_map_ref


@dataclasses.dataclass(frozen=True)
class DistillSpec:
    """Dense-teacher distillation term of the soft-PQ fine-tune.

    weight:      mix of the KL term, loss = (1-w)·CE + w·KL (0 disables)
    temperature: softening τ; the KL is scaled by τ² so that its gradient
                 stays comparable across τ (Hinton et al.)
    """

    weight: float = 0.5
    temperature: float = 2.0

    def __post_init__(self):
        if not (0.0 <= self.weight <= 1.0):
            raise ValueError(f"distill weight must be in [0, 1], got {self.weight}")
        if self.temperature <= 0.0:
            raise ValueError(f"distill temperature must be > 0, got {self.temperature}")

    def to_dict(self) -> dict[str, Any]:
        return {"weight": self.weight, "temperature": self.temperature}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DistillSpec":
        return cls(weight=d["weight"], temperature=d["temperature"])


def make_loss_fn(bundle, *, compute_dtype=torch.bfloat16):
    def loss_fn(params, batch):
        return bundle.loss(params, batch, compute_dtype=compute_dtype)

    return loss_fn


def make_distill_loss_fn(bundle, distill: DistillSpec, teacher_bundle, teacher_params: Any, *,
                         compute_dtype=torch.bfloat16):
    """(params, batch) -> (loss, {"ce", "distill_kl"}) against the frozen dense
    teacher's logits (the same arch in DENSE mode, so the same vocab)."""
    tau = distill.temperature
    w = distill.weight

    def loss_fn(params, batch):
        from repro_torch.models.common import cross_entropy
        from repro_torch.models.transformer import LM_AUX_WEIGHT

        logits, aux = bundle.train_logits(params, batch, compute_dtype=compute_dtype)
        ce = cross_entropy(logits, batch["labels"])
        with torch.no_grad():
            t_logits, _ = teacher_bundle.train_logits(teacher_params, batch,
                                                      compute_dtype=compute_dtype)
        t_logp = torch.log_softmax(t_logits.float() / tau, dim=-1)
        s_logp = torch.log_softmax(logits.float() / tau, dim=-1)
        kl = (torch.exp(t_logp) * (t_logp - s_logp)).sum(-1).mean() * tau ** 2
        loss = (1.0 - w) * ce + w * kl
        # the lm family's MoE penalty rides outside the CE/KL blend: scaled
        # by (1-w) it would switch the router's balancing off at w = 1
        if bundle.kind == "lm":
            loss = loss + LM_AUX_WEIGHT * aux
        return loss, {"ce": ce, "distill_kl": kl}

    return loss_fn


def temperature_stats(params: Any) -> dict[str, torch.Tensor]:
    """Mean and min of t = exp(log_t) over every LUT site of the tree (empty
    for a dense model)."""
    ts: list[torch.Tensor] = []
    tree_map_ref(lambda p, leaf: ts.append(torch.exp(leaf.detach().float()).reshape(-1))
                 if p.rsplit("/", 1)[-1] == "log_t" else None, params)
    if not ts:
        return {}
    t = torch.cat(ts)
    return {"t_mean": t.mean(), "t_min": t.min()}


def _with_aux(loss_fn: Callable) -> Callable:
    """A loss fn normalized to the (loss, aux dict) contract."""

    def fn(params, batch):
        out = loss_fn(params, batch)
        return out if isinstance(out, tuple) else (out, {})

    return fn


def _device_of(params: Any) -> torch.device:
    return params["embed"]["table"].device


def trainable_view(params: Any, frozen: Any) -> tuple[Any, list[torch.Tensor]]:
    """(the params with every non-frozen leaf a fresh view that requires
    grad, those views in walk order). The caller's tensors are untouched."""
    leaves: list[torch.Tensor] = []

    def leaf(_path, p, fz):
        if fz:
            return p
        leaves.append(p.detach().requires_grad_(True))
        return leaves[-1]

    return tree_map_ref(leaf, params, frozen), leaves


def grads_tree(loss: torch.Tensor, leaves: list[torch.Tensor], params: Any, frozen: Any) -> Any:
    """d loss / d each of `trainable_view`'s leaves, in the params' layout:
    None at frozen leaves, zeros where the loss does not reach."""
    grads = iter(torch.autograd.grad(loss, leaves, allow_unused=True))

    def grad(_path, p, fz):
        if fz:
            return None
        g = next(grads)
        return torch.zeros_like(p) if g is None else g

    return tree_map_ref(grad, params, frozen)


def make_grads_fn(bundle, *, compute_dtype=torch.bfloat16, grad_accum: int = 1,
                  loss_fn: Callable | None = None) -> Callable:
    """(params, frozen, batch) -> (loss, aux, grads) of the step: the
    microbatches one after the other when `grad_accum` > 1, their gradients
    summed in fp32 and averaged. The batch's tensors must be on the params'
    device."""
    loss_fn = _with_aux(loss_fn if loss_fn is not None
                        else make_loss_fn(bundle, compute_dtype=compute_dtype))

    def grads_of(params, frozen, batch):
        live, leaves = trainable_view(params, frozen)
        loss, aux = loss_fn(live, batch)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
            grads_tree(loss, leaves, params, frozen)

    def grads_fn(params, frozen, batch):
        if grad_accum == 1:
            return grads_of(params, frozen, batch)
        b = batch["labels"].shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
        per = b // grad_accum
        loss, aux, grads = None, None, None
        for i in range(grad_accum):
            rows = slice(i * per, (i + 1) * per)
            # M-RoPE's pos (3, B, S) splits on its second axis
            mb = {k: v[:, rows] if k == "pos" and v.dim() == 3 else v[rows]
                  for k, v in batch.items()}
            l, a, g = grads_of(params, frozen, mb)
            if grads is None:
                loss, aux = l, a
                grads = tree_map_ref(lambda _p, x: None if x is None else x.float(), g)
            else:
                loss = loss + l
                aux = {k: aux[k] + a[k] for k in aux}
                grads = tree_map_ref(lambda _p, x, y: None if x is None else x + y.float(),
                                     grads, g)
        loss = loss / grad_accum
        aux = {k: v / grad_accum for k, v in aux.items()}
        grads = tree_map_ref(lambda _p, x: None if x is None else x / grad_accum, grads)
        return loss, aux, grads

    return grads_fn


def make_train_step(bundle, opt: AdamW, *, frozen_mask: Any | None = None,
                    compute_dtype=torch.bfloat16, grad_accum: int = 1,
                    loss_fn: Callable | None = None) -> Callable:
    """The step (params, opt_state, batch) -> (params, opt_state, metrics).
    `loss_fn` replaces the plain cross-entropy (e.g. `make_distill_loss_fn`);
    it returns a scalar or (scalar, aux dict), whose entries join the
    metrics. The batch's tensors go to the params' device."""
    grads_fn = make_grads_fn(bundle, compute_dtype=compute_dtype, grad_accum=grad_accum,
                             loss_fn=loss_fn)

    def train_step(params, opt_state: AdamWState, batch):
        dev = _device_of(params)
        batch = {k: v.to(dev) for k, v in batch.items()}
        frozen = frozen_mask if frozen_mask is not None else no_frozen(params)
        loss, aux, grads = grads_fn(params, frozen, batch)
        new_params, new_opt, gnorm = opt.update(grads, opt_state, params, frozen)
        return new_params, new_opt, step_metrics(loss, gnorm, aux, new_params)

    return train_step


def step_metrics(loss: torch.Tensor, gnorm: torch.Tensor, aux: dict, new_params: Any) -> dict:
    metrics = {"loss": loss.float(), "grad_norm": gnorm}
    metrics.update({k: v.float() for k, v in aux.items()})
    metrics.update(temperature_stats(new_params))
    return metrics


def make_compressed_train_step(bundle, opt: AdamW, mesh, *, axis: str = "data",
                               frozen_mask: Any | None = None,
                               compute_dtype=torch.bfloat16) -> Callable:
    """Data-parallel step with the int8 error-feedback gradient reduce
    (`train.grad_compression`) in place of an exact all-reduce over `mesh`'s
    `axis`. EXPERIMENTAL (DESIGN.md §10.4): gradients cross the wire as int8,
    so the numerics differ from the exact step.

    State contract: `opt_state` is `{"opt": AdamWState, "residual": tree}`
    (build it with `init_compressed_state`); each rank takes its rows of the
    global batch (`data_parallel.local_batch`). Otherwise `make_train_step`'s
    contract, so the Trainer drives and checkpoints it unchanged."""
    from repro_torch.train.grad_compression import make_compressed_grad_fn

    grad_fn = make_compressed_grad_fn(make_loss_fn(bundle, compute_dtype=compute_dtype), mesh,
                                      axis=axis)

    def train_step(params, state, batch):
        dev = _device_of(params)
        loss, grads, new_residual = grad_fn(params, state["residual"],
                                            {k: v.to(dev) for k, v in batch.items()})
        new_params, new_opt, gnorm = opt.update(grads, state["opt"], params, frozen_mask)
        return (new_params, {"opt": new_opt, "residual": new_residual},
                step_metrics(loss, gnorm, {}, new_params))

    return train_step


def init_compressed_state(opt: AdamW, params: Any, frozen: Any | None = None) -> dict:
    from repro_torch.train.grad_compression import init_residual

    return {"opt": opt.init(params, frozen), "residual": init_residual(params)}


def make_serve_step(bundle, *, compute_dtype=torch.bfloat16) -> Callable:
    def serve_step(params, batch, caches):
        return bundle.forward_step(params, batch, caches, compute_dtype=compute_dtype)

    return serve_step
