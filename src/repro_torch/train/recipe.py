"""Recipe: the LUT-NN training lifecycle as a resumable object, in PyTorch.

Counterpart of `repro.train.recipe`: dense pretrain -> activation-tape
k-means centroid init (Eq. 1) -> soft-PQ fine-tune with a learned
temperature (section 3.2, optionally distilling against the frozen dense
teacher) -> int8 table deploy -> eval gate.

A `Recipe` is an ordered tuple of stages, each with its own optimizer,
schedule and step count and its own checkpoint directory
(`<ckpt_dir>/<ii>_<name>/`). `Recipe.run(arch, data, ckpt_dir=...)` runs the
stages in order, carrying params across them, on the card unless the caller
asks for the CPU, and keeps an atomic run manifest
(`<ckpt_dir>/recipe_run.json`) of each stage's status and step: a killed run
re-invoked with the same ckpt_dir resumes at the first unfinished stage, and
inside a training stage at its newest committed checkpoint. Recipes, run
manifests and checkpoints are in the reference's formats, so either package
reads what the other wrote. `Deploy` records the executed recipe in the
LUTArtifact's manifest.

Stages:
  * DensePretrain: the dense baseline and teacher; `grad_compression=True`
    (EXPERIMENTAL, DESIGN.md §10.4) reduces its gradients in int8 with
    error feedback over a data mesh: the ranks of the process group the
    caller initialized (`launch.train` under torchrun joins one), else
    this process's one device, where the reference spans every local device
    of its one controller (a kept difference, ROADMAP). In a process group
    of several ranks `Recipe.run` runs no other stage
  * CentroidInit: tape capture + k-means, `convert.convert_dense_to_lut_train`
  * SoftPQ: differentiable centroid learning; `distill=` adds a KL term
    against the frozen dense teacher (DistillSpec)
  * Deploy: int8 tables -> LUTArtifact (+ the recipe)
  * Eval: the deployed-loss gate; a tripped gate retracts the artifact
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpointer import Checkpointer, atomic_write_json
from repro_torch.configs import ArchSpec, arch_to_dict, build_model, effective_plan
from repro_torch.core import convert
from repro_torch.core.amm import Mode
from repro_torch.core.plan import LUTPlan
from repro_torch.device import resolve_device
from repro_torch.optim import DISTILL_RULES, SOFT_PQ_RULES, AdamW, lut_frozen_mask
from repro_torch.optim.schedule import constant, cosine_with_warmup
from repro_torch.launch.mesh import mesh_of_group
from repro_torch.train.train_step import (DistillSpec, init_compressed_state,
                                          make_compressed_train_step, make_distill_loss_fn,
                                          make_train_step)
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.weights import layer_specs, reference_leaves

MANIFEST_NAME = "recipe_run.json"
RUN_FORMAT = "lut-recipe-run"
RUN_VERSION = 1

_RULE_SETS = {"none": (), "soft_pq": SOFT_PQ_RULES, "distill": DISTILL_RULES}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class RecipeError(RuntimeError):
    """Invalid recipe, corrupt run directory, or a failed Eval gate."""


@dataclasses.dataclass(frozen=True)
class OptimSpec:
    """Serializable AdamW + schedule config of one training stage."""

    lr: float = 1e-3
    schedule: str = "cosine"             # "cosine" | "constant"
    warmup_steps: int = 0
    weight_decay: float = 0.0
    rules: str = "none"                  # a named GroupRule set (_RULE_SETS)
    clip_norm: float | None = 1.0

    def __post_init__(self):
        if self.schedule not in ("cosine", "constant"):
            raise RecipeError(f"unknown schedule {self.schedule!r} (have cosine, constant)")
        if self.rules not in _RULE_SETS:
            raise RecipeError(f"unknown rule set {self.rules!r} (have {sorted(_RULE_SETS)})")

    def build(self, total_steps: int) -> AdamW:
        if self.schedule == "cosine":
            lr = cosine_with_warmup(self.lr, total_steps=total_steps,
                                    warmup_steps=self.warmup_steps)
        else:
            lr = constant(self.lr)
        return AdamW(lr=lr, weight_decay=self.weight_decay, rules=_RULE_SETS[self.rules],
                     clip_norm=self.clip_norm)

    def to_dict(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "OptimSpec":
        return cls(**d)


def _dtype(name: str):
    try:
        return _DTYPES[name]
    except KeyError:
        raise RecipeError(f"unknown compute dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class _Stage:
    """Shared stage machinery: serialization and the checkpoint directory."""

    KIND = ""

    def to_dict(self) -> dict[str, Any]:
        out: dict[str, Any] = {"stage": self.KIND}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if dataclasses.is_dataclass(v) else v
        return out

    def _restore_params(self, ctx: "_RunContext", index: int, bundle) -> Any:
        """The stage's committed output params."""
        ck = Checkpointer(ctx.stage_dir(index, self))
        _, tree = ck.restore({"params": layer_specs(bundle)}, device=ctx.device)
        return tree["params"]

    def _restore_lut(self, ctx: "_RunContext", index: int) -> None:
        blut = build_model(ctx.arch, Mode.LUT_TRAIN)
        ctx.lut_bundle = blut
        ctx.lut_params = self._restore_params(ctx, index, blut)


@dataclasses.dataclass(frozen=True)
class DensePretrain(_Stage):
    KIND = "dense_pretrain"

    name: str = "dense"
    steps: int = 200
    optim: OptimSpec = OptimSpec(lr=3e-3, schedule="cosine", warmup_steps=20)
    ckpt_every: int = 50
    log_every: int = 25
    grad_accum: int = 1
    compute_dtype: str = "float32"
    # EXPERIMENTAL (DESIGN.md §10.4): the int8 error-feedback gradient reduce
    # over a data mesh. Changes the step's numerics.
    grad_compression: bool = False

    def __post_init__(self):
        if self.grad_compression and self.grad_accum > 1:
            raise RecipeError("grad_compression does not support grad_accum > 1 — the "
                              "compressed data-parallel step reduces full-batch grads")

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "DensePretrain":
        d = {k: v for k, v in d.items() if k != "stage"}
        d["optim"] = OptimSpec.from_dict(d["optim"])
        return cls(**d)

    def run(self, ctx: "_RunContext", index: int) -> dict[str, Any]:
        bundle = build_model(ctx.arch, Mode.DENSE)
        opt = self.optim.build(self.steps)
        dt = _dtype(self.compute_dtype)
        mesh = None
        if self.grad_compression:
            mesh = mesh_of_group(ctx.device)
            step_fn = make_compressed_train_step(bundle, opt, mesh, compute_dtype=dt)
            state_of = lambda p: init_compressed_state(opt, p)      # noqa: E731
        else:
            step_fn = make_train_step(bundle, opt, compute_dtype=dt, grad_accum=self.grad_accum)
            state_of = opt.init
        params = bundle.init(ctx.generator(), device=ctx.device)
        n = sum(t.numel() for leaves in reference_leaves(params).values() for t in leaves)
        ctx.log(f"[{self.name}] {ctx.arch.name}: {n/1e6:.1f}M params, "
                f"dense pretrain {self.steps} steps"
                + (f" [int8 compressed grads over {mesh.data} rank(s)]" if mesh else ""))
        trainer = Trainer(
            step_fn=step_fn, batch_at=ctx.data.batch_at,
            cfg=TrainerConfig(total_steps=self.steps, ckpt_every=self.ckpt_every,
                              ckpt_dir=str(ctx.stage_dir(index, self)),
                              log_every=self.log_every),
            on_checkpoint=ctx.step_hook(index), mesh=mesh,
        )
        params, _ = trainer.fit(params, state_of(params))        # resumes if killed
        ctx.dense_bundle, ctx.dense_params = bundle, params
        ctx.histories[self.name] = trainer.history
        return {"final_loss": trainer.history[-1]["loss"] if trainer.history else None}

    def restore(self, ctx: "_RunContext", index: int) -> None:
        bundle = build_model(ctx.arch, Mode.DENSE)
        ctx.dense_bundle = bundle
        ctx.dense_params = self._restore_params(ctx, index, bundle)


@dataclasses.dataclass(frozen=True)
class CentroidInit(_Stage):
    KIND = "centroid_init"

    name: str = "centroid_init"
    sample_batches: int = 2
    sample_start: int = 10_000      # batch_at index of the first sample batch
    kmeans_iters: int = 25
    max_rows: int = 4096

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "CentroidInit":
        return cls(**{k: v for k, v in d.items() if k != "stage"})

    def run(self, ctx: "_RunContext", index: int) -> dict[str, Any]:
        ctx.log(f"[{self.name}] k-means centroid init from "
                f"{self.sample_batches} activation sample batches ...")
        samples = [ctx.data.batch_at(self.sample_start + i) for i in range(self.sample_batches)]
        blut, lparams = convert.convert_dense_to_lut_train(
            ctx.dense_bundle, ctx.dense_params, samples, ctx.generator(),
            kmeans_iters=self.kmeans_iters, max_rows=self.max_rows)
        # commit the initialized tree, so that a resume never re-runs the tape
        Checkpointer(ctx.stage_dir(index, self), keep_last=1).save(
            0, {"params": lparams}, blocking=True)
        ctx.lut_bundle, ctx.lut_params = blut, lparams
        return {"lut_sites": len({s.path for s in blut.lut_sites()})}

    def restore(self, ctx: "_RunContext", index: int) -> None:
        self._restore_lut(ctx, index)


@dataclasses.dataclass(frozen=True)
class SoftPQ(_Stage):
    KIND = "soft_pq"

    name: str = "soft_pq"
    steps: int = 200
    optim: OptimSpec = OptimSpec(lr=1e-3, schedule="cosine", warmup_steps=10, rules="soft_pq")
    distill: DistillSpec | None = None
    ckpt_every: int = 50
    log_every: int = 25
    compute_dtype: str = "float32"

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "SoftPQ":
        d = {k: v for k, v in d.items() if k != "stage"}
        d["optim"] = OptimSpec.from_dict(d["optim"])
        if d.get("distill") is not None:
            d["distill"] = DistillSpec.from_dict(d["distill"])
        return cls(**d)

    def run(self, ctx: "_RunContext", index: int) -> dict[str, Any]:
        blut, lparams = ctx.lut_bundle, ctx.lut_params
        frozen = lut_frozen_mask(lparams)
        opt = self.optim.build(self.steps)
        dt = _dtype(self.compute_dtype)
        loss_fn = None
        if self.distill is not None and self.distill.weight > 0.0:
            ctx.log(f"[{self.name}] soft-PQ fine-tune {self.steps} steps, distilling vs "
                    f"frozen dense teacher (w={self.distill.weight}, "
                    f"tau={self.distill.temperature})")
            loss_fn = make_distill_loss_fn(blut, self.distill, ctx.dense_bundle,
                                           ctx.dense_params, compute_dtype=dt)
        else:
            ctx.log(f"[{self.name}] soft-PQ fine-tune {self.steps} steps")
        step_fn = make_train_step(blut, opt, frozen_mask=frozen, compute_dtype=dt,
                                  loss_fn=loss_fn)
        trainer = Trainer(
            step_fn=step_fn, batch_at=ctx.data.batch_at,
            cfg=TrainerConfig(total_steps=self.steps, ckpt_every=self.ckpt_every,
                              ckpt_dir=str(ctx.stage_dir(index, self)),
                              log_every=self.log_every),
            on_checkpoint=ctx.step_hook(index),
        )
        lparams, _ = trainer.fit(lparams, opt.init(lparams, frozen))
        ctx.lut_params = lparams
        ctx.histories[self.name] = trainer.history
        result: dict[str, Any] = {}
        if trainer.history:
            last = trainer.history[-1]
            result = {k: last[k] for k in ("loss", "t_mean", "t_min", "distill_kl") if k in last}
            result["final_loss"] = result.pop("loss")
        return result

    def restore(self, ctx: "_RunContext", index: int) -> None:
        self._restore_lut(ctx, index)


@dataclasses.dataclass(frozen=True)
class Deploy(_Stage):
    """The deploy stage; `target_plan` / `extra_plans` make the artifact
    multi-plan. Each value is a LUTPlan.to_dict payload, the sentinel
    "trained" (the arch's own plan), or {"keeping_dense": [kind patterns]}
    (the trained plan with those kinds kept dense). Every plan must be a
    sub-plan of the trained one; the speculative-decoding pairing is
    target_plan={"keeping_dense": ["attn/*"]}, extra_plans={"draft": "trained"}."""

    KIND = "deploy"

    name: str = "deploy"
    artifact_dir: str | None = None      # default: <ckpt_dir>/artifact
    target_plan: dict[str, Any] | str | None = None
    extra_plans: dict[str, dict[str, Any] | str] | None = None

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Deploy":
        return cls(**{k: v for k, v in d.items() if k != "stage"})

    def _dir(self, ctx: "_RunContext") -> str:
        return self.artifact_dir or str(ctx.ckpt_dir / "artifact")

    @staticmethod
    def _plan(spec, arch):
        if spec is None:
            return None
        if spec == "trained":
            return effective_plan(arch)
        if isinstance(spec, dict) and "keeping_dense" in spec:
            return effective_plan(arch).keeping_dense(*spec["keeping_dense"])
        return LUTPlan.from_dict(spec)

    def run(self, ctx: "_RunContext", index: int) -> dict[str, Any]:
        adir = self._dir(ctx)
        arch = ctx.lut_bundle.arch
        extras = {name: self._plan(spec, arch) for name, spec in (self.extra_plans or {}).items()}
        plans = " + ".join(["target"] + sorted(extras)) if extras else "target"
        ctx.log(f"[{self.name}] building + quantizing int8 tables ({plans}) -> {adir}")
        binf, iparams = convert.deploy_to_artifact(
            ctx.lut_bundle, ctx.lut_params, adir, recipe=ctx.recipe.to_dict(),
            target_plan=self._plan(self.target_plan, arch), extra_plans=extras or None)
        ctx.inf_bundle, ctx.inf_params = binf, iparams
        ctx.artifact_dir = adir
        return {"artifact_dir": adir, "plans": ["target"] + sorted(extras)}

    def restore(self, ctx: "_RunContext", index: int) -> None:
        from repro_torch.serving.artifact import load_artifact

        try:
            art = load_artifact(self._dir(ctx), restore_autotune=False, device=ctx.device)
            ctx.inf_bundle, ctx.inf_params = art.bundle, art.params
            ctx.artifact_dir = self._dir(ctx)
        except (FileNotFoundError, ValueError):
            # the artifact went since the run (a tripped Eval gate retracts
            # it): deploy again, a pure function of the committed soft-PQ params
            self.run(ctx, index)


@dataclasses.dataclass(frozen=True)
class Eval(_Stage):
    """The deployed model's acceptance gate: its loss on
    `data.batch_at(batch_step)` fails the run (RecipeError, manifest status
    "failed", the artifact retracted) past `max_loss`, or more than
    `max_regression` past the dense teacher's loss on the same batch."""

    KIND = "eval"

    name: str = "eval"
    batch_step: int = 99_999
    max_loss: float | None = None
    max_regression: float | None = None
    compute_dtype: str = "float32"

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Eval":
        return cls(**{k: v for k, v in d.items() if k != "stage"})

    def _reject(self, ctx: "_RunContext", reason: str) -> None:
        """Retract the artifact already written, so that nothing downstream
        ships the deployment the gate rejected; then fail the run."""
        if ctx.artifact_dir is not None:
            for suffix in ("", ".old"):
                shutil.rmtree(str(ctx.artifact_dir) + suffix, ignore_errors=True)
            ctx.log(f"[{self.name}] gate tripped — retracted artifact at {ctx.artifact_dir}")
        raise RecipeError(reason)

    def run(self, ctx: "_RunContext", index: int) -> dict[str, Any]:
        dt = _dtype(self.compute_dtype)
        batch = {k: v.to(ctx.device) for k, v in ctx.data.batch_at(self.batch_step).items()}
        with torch.no_grad():
            loss = float(ctx.inf_bundle.loss(ctx.inf_params, batch, compute_dtype=dt))
        result: dict[str, Any] = {"deployed_loss": loss}
        ctx.log(f"[{self.name}] deployed INT8 LUT eval loss: {loss:.4f}")
        if self.max_regression is not None:
            with torch.no_grad():
                ref = float(ctx.dense_bundle.loss(ctx.dense_params, batch, compute_dtype=dt))
            result["dense_loss"] = ref
            if loss > ref + self.max_regression:
                self._reject(ctx, (f"eval gate: deployed loss {loss:.4f} regresses "
                                   f"{loss - ref:.4f} past dense {ref:.4f} "
                                   f"(max_regression={self.max_regression})"))
        if self.max_loss is not None and loss > self.max_loss:
            self._reject(ctx, f"eval gate: deployed loss {loss:.4f} > max_loss {self.max_loss}")
        return result

    def restore(self, ctx: "_RunContext", index: int) -> None:
        pass                       # the result lives in the manifest


STAGE_TYPES: dict[str, type] = {
    c.KIND: c for c in (DensePretrain, CentroidInit, SoftPQ, Deploy, Eval)
}

# a stage KIND -> the stage KINDs at least one of which must come earlier
_REQUIRES: dict[str, tuple[str, ...]] = {
    CentroidInit.KIND: (DensePretrain.KIND,),
    SoftPQ.KIND: (CentroidInit.KIND,),
    Deploy.KIND: (CentroidInit.KIND,),       # deploy without fine-tune: a paper baseline
    Eval.KIND: (Deploy.KIND,),
}


@dataclasses.dataclass
class _RunContext:
    recipe: "Recipe"
    arch: ArchSpec
    data: Any                       # needs .batch_at(step)
    ckpt_dir: pathlib.Path
    seed: int
    device: torch.device
    manifest: "_RunManifest"
    verbose: bool = True

    dense_bundle: Any = None
    dense_params: Any = None
    lut_bundle: Any = None
    lut_params: Any = None
    inf_bundle: Any = None
    inf_params: Any = None
    artifact_dir: str | None = None
    histories: dict[str, list] = dataclasses.field(default_factory=dict)

    def generator(self) -> torch.Generator:
        """A fresh generator on the run's device, seeded with the run's seed
        (the port's counterpart of the reference's PRNGKey(seed))."""
        return torch.Generator(device=self.device).manual_seed(self.seed)

    def stage_dir(self, index: int, stage: _Stage) -> pathlib.Path:
        return self.ckpt_dir / f"{index:02d}_{stage.name}"

    def step_hook(self, index: int) -> Callable[[int], None]:
        return lambda step: self.manifest.set_step(index, step)

    def log(self, msg: str) -> None:
        if self.verbose:
            print(msg, flush=True)


class _RunManifest:
    """Atomic per-run state: stage status, step and results, in the
    reference's `recipe_run.json` format. The source of truth for the
    position inside a stage is the stage's own newest committed checkpoint;
    the manifest's step follows each commit."""

    def __init__(self, path: pathlib.Path, recipe: "Recipe", arch_dict: dict[str, Any],
                 seed: int, data_fingerprint: str | None):
        self.path = path
        if path.exists():
            self.state = json.loads(path.read_text())
            if self.state.get("format") != RUN_FORMAT:
                raise RecipeError(f"{path} is not a recipe-run manifest")
            checks = [("arch", arch_dict, "arch"), ("seed", seed, "seed")]
            if data_fingerprint is not None and self.state.get("data") is not None:
                checks.append(("data", data_fingerprint, "data configuration"))
            for field, want, what in checks:
                if self.state.get(field) != want:
                    raise RecipeError(
                        f"{path.parent} holds a run of a DIFFERENT {what} — refusing to "
                        "resume (use a fresh --ckpt-dir, or re-invoke with the original "
                        "arguments)")
            self._reconcile_recipe(recipe)
        else:
            self.state = {
                "format": RUN_FORMAT,
                "version": RUN_VERSION,
                "recipe": recipe.to_dict(),
                "arch": arch_dict,
                "seed": seed,
                "data": data_fingerprint,
                "stages": [{"name": s.name, "kind": s.KIND, "status": "pending",
                            "step": None, "result": None} for s in recipe.stages],
            }
            self._write()

    def _write(self) -> None:
        # in a process group, rank 0 alone writes (each rank keeps the state)
        if not dist.is_initialized() or dist.get_rank() == 0:
            atomic_write_json(self.path, self.state)

    def _reconcile_recipe(self, recipe: "Recipe") -> None:
        """Accept a recipe that differs from the recorded one only at stages
        with no committed state (pending or failed): loosening a failed Eval
        gate resumes in place. Stages done or running must match exactly."""
        new = recipe.to_dict()
        old = self.state["recipe"]
        if new == old:
            return
        entries = self.state["stages"]
        olds, news = old.get("stages", []), new["stages"]
        compatible = (
            old.get("version") == new["version"]
            and len(olds) == len(news) == len(entries)
            and all(o["stage"] == n["stage"] and o["name"] == n["name"]
                    for o, n in zip(olds, news))
            and all(o == n for o, n, e in zip(olds, news, entries)
                    if e["status"] in ("done", "running"))
        )
        if not compatible:
            raise RecipeError(
                f"{self.path.parent} holds a run of a DIFFERENT recipe — refusing to resume: "
                "only stages with no committed state (pending/failed) may change between "
                "invocations (use a fresh --ckpt-dir for a different pipeline)")
        self.state["recipe"] = new
        self._write()

    def status(self, index: int) -> str:
        return self.state["stages"][index]["status"]

    def set_status(self, index: int, status: str, result: dict[str, Any] | None = None) -> None:
        e = self.state["stages"][index]
        e["status"] = status
        if result is not None:
            e["result"] = result
        self._write()

    def set_step(self, index: int, step: int) -> None:
        self.state["stages"][index]["step"] = step
        self._write()


@dataclasses.dataclass(frozen=True)
class RecipeResult:
    """What `Recipe.run` hands back: the carried trees and the run record."""

    manifest: dict[str, Any]
    dense_bundle: Any = None
    dense_params: Any = None
    lut_bundle: Any = None
    lut_params: Any = None
    inf_bundle: Any = None
    inf_params: Any = None
    histories: dict[str, list] = dataclasses.field(default_factory=dict)

    def stage_result(self, name: str) -> dict[str, Any] | None:
        for e in self.manifest["stages"]:
            if e["name"] == name:
                return e["result"]
        return None


@dataclasses.dataclass(frozen=True)
class Recipe:
    stages: tuple[_Stage, ...]

    def validate(self) -> "Recipe":
        if not self.stages:
            raise RecipeError("recipe has no stages")
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise RecipeError(f"stage names must be unique, got {names}")
        for n in names:
            if not n or "/" in n or n != n.strip():
                raise RecipeError(f"invalid stage name {n!r}")
        seen: set[str] = set()
        for s in self.stages:
            need = _REQUIRES.get(s.KIND, ())
            if need and not any(k in seen for k in need):
                raise RecipeError(f"stage {s.name!r} ({s.KIND}) requires an earlier "
                                  f"{' or '.join(need)} stage")
            seen.add(s.KIND)
        return self

    def to_dict(self) -> dict[str, Any]:
        return {"version": 1, "stages": [s.to_dict() for s in self.stages]}

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "Recipe":
        if d.get("version") != 1:
            raise RecipeError(f"unknown recipe version {d.get('version')!r}")
        stages = []
        for sd in d["stages"]:
            kind = sd.get("stage")
            if kind not in STAGE_TYPES:
                raise RecipeError(f"unknown stage kind {kind!r} (have {sorted(STAGE_TYPES)})")
            stages.append(STAGE_TYPES[kind].from_dict(sd))
        return cls(stages=tuple(stages)).validate()

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "Recipe":
        return cls.from_dict(json.loads(text))

    @classmethod
    def load(cls, path: str | os.PathLike) -> "Recipe":
        return cls.from_json(pathlib.Path(path).read_text())

    def save(self, path: str | os.PathLike) -> None:
        atomic_write_json(path, self.to_dict())

    def describe(self) -> str:
        bits = []
        for s in self.stages:
            extra = ""
            if isinstance(s, (DensePretrain, SoftPQ)):
                extra = f"[{s.steps}]"
                if isinstance(s, SoftPQ) and s.distill is not None:
                    extra += f"+distill(w={s.distill.weight})"
                if isinstance(s, DensePretrain) and s.grad_compression:
                    extra += "+int8grads"
            bits.append(f"{s.name}{extra}")
        return " -> ".join(bits)

    def run(self, arch: ArchSpec, data: Any, *, ckpt_dir: str | os.PathLike, seed: int = 0,
            verbose: bool = True, device: str | torch.device | None = None) -> RecipeResult:
        """Run (or resume) the pipeline under `ckpt_dir` on `device` (the card
        unless the caller asks for the CPU). `data` gives deterministic
        `batch_at(step)` batches: a killed run re-invoked with the same
        arguments resumes at the manifest's first unfinished stage, and
        inside a training stage at its newest committed checkpoint."""
        self.validate()
        if dist.is_initialized() and dist.get_world_size() > 1:
            # every rank would run these stages whole and write their files
            alone = [s.name for s in self.stages
                     if not (isinstance(s, DensePretrain) and s.grad_compression)]
            if alone:
                raise RecipeError(
                    f"stages {alone} do not run over the {dist.get_world_size()} ranks of "
                    f"the process group: only DensePretrain(grad_compression=True) does, as the "
                    f"reference spans devices in that stage alone "
                    f"(repro.train.recipe.DensePretrain)")
        dev = resolve_device(device)
        ckpt_dir = pathlib.Path(ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        # a dataclass data source (MarkovLM) has a deterministic repr of its
        # vocab/seq/batch/seed: a resume with other data flags is refused
        fp = repr(data) if dataclasses.is_dataclass(data) and not isinstance(data, type) else None
        manifest = _RunManifest(ckpt_dir / MANIFEST_NAME, self, arch_to_dict(arch), seed, fp)
        ctx = _RunContext(recipe=self, arch=arch, data=data, ckpt_dir=ckpt_dir, seed=seed,
                          device=dev, manifest=manifest, verbose=verbose)
        for i, stage in enumerate(self.stages):
            if manifest.status(i) == "done":
                stage.restore(ctx, i)
                ctx.log(f"[{stage.name}] already done — restored")
                continue
            manifest.set_status(i, "running")
            try:
                result = stage.run(ctx, i)
            except RecipeError as e:
                manifest.set_status(i, "failed", {"error": str(e)})
                raise
            manifest.set_status(i, "done", result)
        return RecipeResult(
            manifest=manifest.state,
            dense_bundle=ctx.dense_bundle, dense_params=ctx.dense_params,
            lut_bundle=ctx.lut_bundle, lut_params=ctx.lut_params,
            inf_bundle=ctx.inf_bundle, inf_params=ctx.inf_params,
            histories=ctx.histories,
        )


def default_recipe(*, steps: int = 200, lut: bool = True, artifact_dir: str | None = None,
                   distill_weight: float = 0.0, distill_tau: float = 2.0, grad_accum: int = 1,
                   grad_compression: bool = False, eval_max_regression: float | None = None,
                   spec_draft: str | None = None) -> Recipe:
    """The launcher's pipeline as a Recipe, the reference's stages and
    hyperparameters. `spec_draft` deploys a two-plan artifact for
    speculative serving: the trained plan ships as the "draft" and the
    target keeps the named kinds dense (comma-separated glob patterns, e.g.
    "attn/*"): one checkpoint, two plans, shared tables."""
    ckpt_every = max(50, steps // 4)
    dense = DensePretrain(
        steps=steps, optim=OptimSpec(lr=3e-3, schedule="cosine", warmup_steps=20),
        ckpt_every=ckpt_every, log_every=25, grad_accum=grad_accum,
        grad_compression=grad_compression,
    )
    if not lut:
        return Recipe(stages=(dense,)).validate()
    distill = (DistillSpec(weight=distill_weight, temperature=distill_tau)
               if distill_weight > 0.0 else None)
    deploy = Deploy(artifact_dir=artifact_dir)
    if spec_draft:
        kinds = [k.strip() for k in spec_draft.split(",") if k.strip()]
        deploy = dataclasses.replace(deploy, target_plan={"keeping_dense": kinds},
                                     extra_plans={"draft": "trained"})
    return Recipe(stages=(
        dense,
        CentroidInit(sample_batches=2, sample_start=10_000),
        SoftPQ(steps=steps,
               optim=OptimSpec(lr=1e-3, schedule="cosine", warmup_steps=10,
                               rules="distill" if distill else "soft_pq"),
               distill=distill, ckpt_every=ckpt_every, log_every=25),
        deploy,
        Eval(batch_step=99_999, max_regression=eval_max_regression),
    )).validate()
