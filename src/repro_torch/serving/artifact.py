"""Versioned LUT deployment artifacts: load and write the reference's format.

Counterpart of `repro.serving.artifact`. An artifact is a directory

  <dir>/
      manifest.json     format + version, arch-spec fields, the resolved plan,
                        mode, bundle kind, tree structure, per-leaf shape/dtype
      arrays.npz        every param leaf keyed by its tree path in the
                        reference's layer-stacked layout (dtype-exact: int8
                        tables stay int8, bfloat16 travels as uint16 bits)
      autotune.json     the autotune records of the artifact's kernel sites

that either package writes and either package reads: the port unstacks the
layers on load (`weights.params_from_numpy`) and restacks them on save
(`weights.params_to_numpy`). Manifest versions 1-3 are read, with the
reference's migrations: a v1 manifest carries no plan (its arch's legacy
`lut_policy` resolves it), a v2 manifest no extra plans.

Writes follow the reference's atomic discipline: everything lands in
`<dir>.tmp`; a previous artifact moves to `<dir>.old` before the commit and
is removed after it, and a reader falls back to `<dir>.old` when a crash
left `<dir>` without a manifest.

The autotune snapshot carries records keyed by backend: the reference's
(`tpu`, `cpu`) and the port's (`cuda-sm90`, `torch-cpu`) can travel in one
artifact and never steer each other's kernels.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.paths import flatten_tree, treedef_string, unflatten_tree
from repro_torch.configs import (
    ModelBundle,
    arch_from_dict,
    arch_to_dict,
    build_model,
    effective_plan,
)
from repro_torch.core.amm import Mode
from repro_torch.core.plan import LUTPlan
from repro_torch.device import resolve_device
from repro_torch.kernels import autotune
from repro_torch.serving.engine import lut_kernel_signatures
from repro_torch.weights import first_layers, params_from_numpy, params_to_numpy

FORMAT = "lut-artifact"
VERSION = 3
_READABLE_VERSIONS = (1, 2, 3)

#: the reserved name of the main plan every artifact carries
TARGET_PLAN = "target"

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"
_AUTOTUNE = "autotune.json"


@dataclasses.dataclass(frozen=True)
class LUTArtifact:
    """A loaded deployment artifact: the rebuilt bundle and its params."""

    bundle: ModelBundle
    params: Any
    manifest: dict[str, Any]
    path: pathlib.Path
    plan_name: str = TARGET_PLAN

    @property
    def arch_name(self) -> str:
        return self.manifest["arch"]["name"]

    @property
    def plan_names(self) -> list[str]:
        """Every plan this artifact can resolve, target first."""
        return [TARGET_PLAN] + sorted(self.manifest.get("plans", {}))

    @property
    def recipe(self) -> dict[str, Any] | None:
        """The training recipe the writer recorded, if any (provenance only)."""
        return self.manifest.get("recipe")


def _arch_sans_plan(arch) -> dict[str, Any]:
    d = arch_to_dict(arch)
    d.pop("lut_plan", None)
    return d


def _host_leaves(bundle: ModelBundle, params: Any) -> tuple[dict[str, np.ndarray],
                                                            dict[str, str]]:
    """({path: host array}, {path: dtype name}) of the port's params in the
    reference's layer-stacked layout; bfloat16 arrays are uint16 bits."""
    arrays = flatten_tree(params_to_numpy(bundle, params))
    dtypes = {p: autotune.dtype_name(t.dtype)
              for p, t in flatten_tree(first_layers(params)).items()}
    return arrays, dtypes


def save_artifact(directory: str | os.PathLike, bundle: ModelBundle, params: Any, *,
                  autotune_snapshot: bool = True, recipe: dict[str, Any] | None = None,
                  extra_plans: dict[str, tuple[ModelBundle, Any]] | None = None
                  ) -> pathlib.Path:
    """Write `(bundle, params)` as a LUTArtifact directory (atomic).

    `extra_plans` maps further plan names (e.g. "draft") to `(bundle, params)`
    pairs of the same arch under another LUTPlan; a leaf byte-identical to
    the target's leaf at the same path is stored once and referenced by key."""
    final = pathlib.Path(directory)
    tmp = final.parent / (final.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    flat, dtypes = _host_leaves(bundle, params)
    arrays = dict(flat)
    plans: dict[str, Any] = {}
    for name, (pbundle, pparams) in (extra_plans or {}).items():
        if name == TARGET_PLAN:
            raise ValueError(f"plan name {TARGET_PLAN!r} is reserved for the artifact's main "
                             f"(bundle, params)")
        if (pbundle.mode != bundle.mode or pbundle.kind != bundle.kind
                or _arch_sans_plan(pbundle.arch) != _arch_sans_plan(bundle.arch)):
            raise ValueError(f"extra plan {name!r}: its bundle must share the target's "
                             f"arch/mode/kind modulo lut_plan")
        pflat, pdtypes = _host_leaves(pbundle, pparams)
        leaves = {}
        for path, a in pflat.items():
            shared = flat.get(path)
            if (shared is not None and dtypes[path] == pdtypes[path]
                    and shared.shape == a.shape and shared.tobytes() == a.tobytes()):
                key = path                       # dedupe: reuse the target leaf
            else:
                key = f"plan.{name}/{path}"
                arrays[key] = a
            leaves[path] = {"shape": list(a.shape), "dtype": pdtypes[path], "key": key}
        plans[name] = {"plan": effective_plan(pbundle.arch).to_dict(), "leaves": leaves}

    np.savez(tmp / _ARRAYS, **arrays)
    manifest = {
        "format": FORMAT,
        "version": VERSION,
        "arch": arch_to_dict(bundle.arch),
        "plan": effective_plan(bundle.arch).to_dict(),
        "mode": bundle.mode.value,
        "kind": bundle.kind,
        "treedef": treedef_string(unflatten_tree(flat)),
        "leaves": {p: {"shape": list(a.shape), "dtype": dtypes[p]} for p, a in flat.items()},
    }
    if plans:
        manifest["plans"] = plans
    if recipe is not None:
        manifest["recipe"] = recipe
    (tmp / _MANIFEST).write_text(json.dumps(manifest, indent=2))

    if autotune_snapshot:
        entries = _snapshot_entries([bundle] + [b for b, _ in (extra_plans or {}).values()])
        (tmp / _AUTOTUNE).write_text(
            json.dumps({"version": 1, "entries": entries}, indent=1, sort_keys=True))

    # commit: the previous artifact moves aside before the replace, so that at
    # every instant <dir> or <dir>.old is loadable
    old = final.parent / (final.name + ".old")
    if final.exists():
        if old.exists():
            shutil.rmtree(old)
        os.replace(final, old)
    os.replace(tmp, final)
    if old.exists():
        shutil.rmtree(old)
    return final


def _snapshot_entries(bundles: list[ModelBundle]) -> dict[str, Any]:
    """The process cache's records of these bundles' kernel sites, matched
    on the (M, C, K, V) signature (any N, dtype, backend): "lut_amm" records
    and the "encode" records of the same codebooks."""
    sites = set()
    for bundle in bundles:
        for m, c, k, v in lut_kernel_signatures(bundle):
            sites.add(("lut_amm", m, c, k, v))
            sites.add(("encode", 0, c, k, v))
    if not sites:
        return {}

    def key_sig(key: str) -> tuple | None:
        parts = key.split("|")
        try:
            f = dict(p.split("=", 1) for p in parts[1:])
            return parts[0], int(f["m"]), int(f["c"]), int(f["k"]), int(f["v"])
        except (IndexError, KeyError, ValueError):
            return None

    return {k: dict(rec) for k, rec in autotune.get_cache().load().items()
            if key_sig(k) in sites}


def _read_manifest(directory: pathlib.Path) -> dict[str, Any]:
    try:
        manifest = json.loads((directory / _MANIFEST).read_text())
    except FileNotFoundError:
        raise FileNotFoundError(f"no {_MANIFEST} in {directory}: not an artifact") from None
    if manifest.get("format") != FORMAT:
        raise ValueError(f"{directory}: format={manifest.get('format')!r}, expected {FORMAT!r}")
    if manifest.get("version") not in _READABLE_VERSIONS:
        raise ValueError(f"{directory}: artifact version {manifest.get('version')} "
                         f"unsupported (reader: {VERSION})")
    return manifest


def _resolve_artifact_dir(directory: str | os.PathLike) -> pathlib.Path:
    """`<dir>`, or `<dir>.old` when a crash between save_artifact's two
    replaces left the previous artifact there and `<dir>` without a manifest."""
    directory = pathlib.Path(directory)
    if not (directory / _MANIFEST).exists():
        old = directory.parent / (directory.name + ".old")
        if (old / _MANIFEST).exists():
            return old
    return directory


def check_artifact_dir(directory: str | os.PathLike) -> dict[str, Any]:
    """Resolve the directory (with the .old fallback) and validate its
    manifest without reading the arrays; FileNotFoundError when it is gone,
    ValueError when the manifest is invalid."""
    resolved = _resolve_artifact_dir(directory)
    try:
        return _read_manifest(resolved)
    except json.JSONDecodeError as e:
        raise ValueError(f"{resolved}: unreadable {_MANIFEST}: {e}") from e


def load_artifact(directory: str | os.PathLike, *, plan: str = TARGET_PLAN,
                  restore_autotune: bool = True,
                  device: str | torch.device | None = None, mesh: Any = None) -> LUTArtifact:
    """Rebuild the bundle and params of a saved artifact on `device` (the
    card unless the caller asks for the CPU). Every leaf is checked against
    the manifest and the rebuilt model (path, shape, dtype) before use.
    `plan` picks the target or a named extra plan of a v3 artifact. With a
    tensor-parallel `mesh` (`launch/mesh.py`), the params are this rank's
    shards only, placed by `ShardingRules` on the mesh's device
    (`tensor_parallel.RankParams`, what `ServingEngine(..., mesh=)` takes):
    each leaf is cut on the host before it reaches the device."""
    device = mesh.device if mesh is not None and device is None else resolve_device(device)
    primary = pathlib.Path(directory)
    resolved = _resolve_artifact_dir(primary)
    try:
        return _load_resolved(resolved, plan=plan, restore_autotune=restore_autotune,
                              device=device, mesh=mesh)
    except FileNotFoundError:
        if resolved == primary:
            raise
        # a re-deploy committed while we read <dir>.old: the new one is at <dir>
        return _load_resolved(primary, plan=plan, restore_autotune=restore_autotune,
                              device=device, mesh=mesh)


def _plan_arch(manifest: dict[str, Any], directory, plan: str):
    """(arch, leaf records, npz key of each path) for the requested plan."""
    arch = arch_from_dict(manifest["arch"])
    if plan == TARGET_PLAN:
        recorded = manifest["leaves"]
        return arch, recorded, {p: p for p in recorded}
    plans = manifest.get("plans", {})
    if plan not in plans:
        have = [TARGET_PLAN] + sorted(plans)
        raise ValueError(f"{directory}: no plan {plan!r} in this artifact; available: {have}"
                         + ("" if plans else
                            f" (v{manifest['version']} artifact: single-plan)"))
    entry = plans[plan]
    arch = dataclasses.replace(arch, lut_plan=LUTPlan.from_dict(entry["plan"]))
    recorded = entry["leaves"]
    return arch, recorded, {p: rec["key"] for p, rec in recorded.items()}


def _tensor_of(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _load_resolved(directory: pathlib.Path, *, plan: str, restore_autotune: bool,
                   device: torch.device, mesh: Any = None) -> LUTArtifact:
    manifest = _read_manifest(directory)
    arch, recorded, keymap = _plan_arch(manifest, directory, plan)
    if manifest["version"] >= 2 and plan == TARGET_PLAN:
        rec_plan = LUTPlan.from_dict(manifest["plan"])
        if rec_plan != effective_plan(arch):
            raise ValueError(f"{directory}: manifest plan does not match the arch's resolved "
                             f"plan: {rec_plan.describe()} vs {effective_plan(arch).describe()}")
    bundle = build_model(arch, Mode(manifest["mode"]))
    if bundle.kind != manifest["kind"]:
        raise ValueError(f"rebuilt bundle kind {bundle.kind!r} != manifest {manifest['kind']!r}")

    specs = flatten_tree(bundle.param_specs())
    flat = {}
    with np.load(directory / _ARRAYS) as data:
        missing = [p for p in specs if p not in recorded or keymap[p] not in data.files]
        extra = (sorted(k for k in set(data.files) - set(specs) if not k.startswith("plan."))
                 if plan == TARGET_PLAN else [])
        if missing or extra:
            raise ValueError(f"artifact/model tree mismatch: missing={missing[:4]} "
                             f"extra={extra[:4]}")
        for p, spec in specs.items():
            a = data[keymap[p]]
            rec = recorded[p]
            stored = "bfloat16" if rec["dtype"] == "bfloat16" and a.dtype == np.uint16 \
                else str(a.dtype)
            if list(a.shape) != rec["shape"] or stored != rec["dtype"]:
                raise ValueError(f"{p}: stored {a.shape}/{stored} != manifest {rec}")
            want = autotune.dtype_name(spec.dtype)
            if a.shape != tuple(spec.shape) or stored != want:
                raise ValueError(f"{p}: artifact {a.shape}/{stored} != model "
                                 f"{tuple(spec.shape)}/{want}")
            flat[p] = _tensor_of(a, stored)
    if mesh is not None:
        from repro_torch.distributed import sharding, tensor_parallel

        rules = sharding.ShardingRules.for_mesh(mesh)
        lay = tensor_parallel.layout(bundle, rules)
        local = tensor_parallel.local_bundle(bundle, lay)
        tree = params_from_numpy(local, unflatten_tree(
            tensor_parallel.shard_arrays(flat, lay, mesh.model_rank)), device=device)
        params = tensor_parallel.RankParams(tree=tree, rank=mesh.model_rank, tp=rules.tp)
    else:
        params = params_from_numpy(bundle, unflatten_tree(flat), device=device)
    if restore_autotune:
        restore_autotune_snapshot(directory)
    return LUTArtifact(bundle=bundle, params=params, manifest=manifest, path=directory,
                       plan_name=plan)


def restore_autotune_snapshot(directory: str | os.PathLike) -> int:
    """Merge the artifact's autotune records into the process cache, with
    precedence measured > snapshot > analytic: a snapshot record fills a
    hole, and a measured one also replaces a live analytic record, never a
    live measured one. Returns the number merged. A missing or malformed
    snapshot merges nothing and is not an error."""
    path = pathlib.Path(directory) / _AUTOTUNE
    cache = autotune.get_cache()
    merged = 0
    try:
        raw = json.loads(path.read_text())
        entries = raw["entries"] if raw.get("version") == 1 else {}
        for key, rec in entries.items():
            have = cache.get(key)
            if have is None or (isinstance(rec, dict) and rec.get("measured")
                                and not have.get("measured")):
                cache.put(key, dict(rec))
                merged += 1
    except (OSError, ValueError, KeyError, TypeError, AttributeError):
        return merged
    if merged:
        try:
            cache.save()
        except OSError:
            pass
    return merged


def describe_artifact(directory: str | os.PathLike) -> str:
    """Human-readable summary: arch, mode, every plan with its LUT site
    count, leaf accounting and recorded recipe."""
    directory = _resolve_artifact_dir(directory)
    manifest = _read_manifest(directory)
    arch = arch_from_dict(manifest["arch"])
    leaves = manifest["leaves"]

    def rec_bytes(rec) -> int:
        dt = np.uint16 if rec["dtype"] == "bfloat16" else np.dtype(rec["dtype"])
        return int(np.prod(rec["shape"] or [1])) * np.dtype(dt).itemsize

    def lut_sites(a) -> str:
        sites = build_model(a, Mode(manifest["mode"])).sites()
        return f"{sum(s.mode != Mode.DENSE for s in sites)}/{len(sites)} sites LUT"

    plans = manifest.get("plans", {})
    lines = [
        f"LUTArtifact at {directory}",
        f"  format    : {manifest['format']} v{manifest['version']}",
        f"  arch      : {arch.name} ({arch.family}, {arch.n_layers}L, d={arch.d_model}, "
        f"vocab={arch.vocab})",
        f"  mode/kind : {manifest['mode']} / {manifest['kind']}",
        f"  leaves    : {len(leaves)} arrays, "
        f"{sum(rec_bytes(r) for r in leaves.values()) / 1e6:.2f} MB",
        f"  plans     : {', '.join([TARGET_PLAN] + sorted(plans))}",
        f"    {TARGET_PLAN:<8}: {lut_sites(arch)}, {effective_plan(arch).describe()}",
    ]
    for name in sorted(plans):
        parch = dataclasses.replace(arch, lut_plan=LUTPlan.from_dict(plans[name]["plan"]))
        shared = sum(1 for r in plans[name]["leaves"].values() if not r["key"].startswith("plan."))
        lines.append(f"    {name:<8}: {lut_sites(parch)}, {shared}/{len(plans[name]['leaves'])} "
                     f"leaves shared with {TARGET_PLAN}")
    recipe = manifest.get("recipe")
    stages = " -> ".join(s.get("name", s.get("stage", "?")) for s in recipe.get("stages", [])) \
        if recipe else "(none recorded)"
    lines.append(f"  recipe    : {stages}")
    return "\n".join(lines)


def _main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(prog="python -m repro_torch.serving.artifact",
                                 description="Inspect a LUTArtifact directory.")
    ap.add_argument("directory", help="artifact directory to describe")
    ap.add_argument("--json", action="store_true", help="dump the raw manifest JSON instead")
    args = ap.parse_args(argv)
    if args.json:
        print(json.dumps(check_artifact_dir(args.directory), indent=2))
    else:
        print(describe_artifact(args.directory))


if __name__ == "__main__":
    _main()
