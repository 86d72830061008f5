"""Dense -> LUT model conversion (the paper's offline pipeline, section 6.1),
in PyTorch.

Counterpart of `repro.core.convert`:
  1. graft: the trained dense model's weights go into a LUT_TRAIN model of
     the same arch; replaced sites keep their dense weight as the frozen
     table source;
  2. k-means init: the dense model runs the sample batches with the
     activation tape on, and every replaced site's inputs are clustered per
     codebook (Eq. 1) into its centroids;
  3. deploy (after soft-PQ fine-tuning): the tables are built and int8
     quantized and the dense weights dropped, giving the serving params;
     `deploy_to_artifact` writes them as a LUTArtifact.

The passes walk the site registry (`ModelBundle.sites()`) for every family
(lm segments, the hybrid's mamba stack and shared block, the enc-dec's
encoder and decoder, the MoE expert sites): tape records join centroid
leaves on (layer, kind), and each deployed table is built with its own
site's LUTConfig. Segments of the two models may group the layers
differently (the LUT plan splits them into runs); leaves are matched through
global layer indices.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import ModelBundle, build_model
from repro_torch.core import kmeans, lut_layer, pq
from repro_torch.core.amm import Mode
from repro_torch.models.common import tape_capture
from repro_torch.weights import layer_specs, tree_map_ref

# LUT_TRAIN leaves with no dense source: they keep their fresh init through
# the graft. Any other unmatched leaf is a drifted tree and fails loudly.
_TRAINABLE_LUT_LEAVES = ("centroids", "log_t")


def site_params(params: Any, spec) -> dict[str, Any]:
    """A site's param dict in the port's layout, from its registry entry
    (`ModelBundle.sites()`): a segment's layer, a layer of a top-level stack
    (the hybrid's mamba_stack, the enc-dec's encoder and decoder), or a
    path from the root (the hybrid's shared block, lm_head)."""
    parts = spec.path.split("/")
    if parts[0] == "segments":
        node, rest = params["segments"][int(parts[1])][spec.stack_index], parts[2:]
    elif isinstance(params.get(parts[0]), list):
        node, rest = params[parts[0]][spec.stack_index], parts[1:]
    else:
        node, rest = params, parts
    for part in rest:
        node = node[part]
    return node


def _global(params: Any) -> Any:
    """The tree with an lm's segments joined into one list of layers in
    global order: the dense and LUT trees of one arch (or two LUT plans)
    then line up leaf for leaf, whatever runs their plans group layers into."""
    if "segments" in params:
        return dict(params, segments=[layer for seg in params["segments"] for layer in seg])
    return params


def _regroup(view: Any, like: Any) -> Any:
    """`_global`'s inverse: the layers split into `like`'s segment lengths."""
    if "segments" not in like:
        return view
    out, lo = [], 0
    for seg in like["segments"]:
        out.append(view["segments"][lo: lo + len(seg)])
        lo += len(seg)
    return dict(view, segments=out)


def _zip_map(fn, tree: Any, other: Any, path: str = "") -> Any:
    """fn(path, leaf, other's leaf at the same place or None) over `tree`."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other.get(k) if isinstance(other, dict) else None,
                            f"{path}/{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zip_map(fn, v, other[i] if isinstance(other, list) and i < len(other) else None,
                         f"{path}/{i}") for i, v in enumerate(tree)]
    return fn(path, tree, other)


def _copy_tree(params: Any) -> Any:
    """New dicts and lists holding the same tensors."""
    return tree_map_ref(lambda _p, t: t, params)


def graft_dense_to_lut(dense_params: Any, lut_params: Any) -> Any:
    """The LUT_TRAIN tree with every leaf the dense model shares (w, b, norms,
    embedding; an expert site's stacked w) taken from the dense model; only
    centroids and log_t keep their init. An lm's layers line up by global
    index; every other family's trees share one structure."""
    def pick(path: str, leaf: torch.Tensor, src: Any) -> torch.Tensor:
        if isinstance(src, torch.Tensor) and src.shape == leaf.shape:
            return src
        if path.rsplit("/", 1)[-1] in _TRAINABLE_LUT_LEAVES:
            return leaf
        raise ValueError(f"graft: no dense source for {path} (shape {tuple(leaf.shape)}): the "
                         f"dense and LUT models were built from different archs/plans")

    return _regroup(_zip_map(pick, _global(lut_params), _global(dense_params)), lut_params)


def kmeans_init_lut(bundle_dense: ModelBundle, dense_params: Any, bundle_lut: ModelBundle,
                    lut_params: Any, sample_batches: list[dict[str, torch.Tensor]],
                    gen: torch.Generator, *, kmeans_iters: int = 25,
                    max_rows: int = 4096) -> Any:
    """Capture the replaced sites' inputs under the original dense model
    (paper section 6.1) and k-means-init every centroid table of the LUT
    model (Eq. 1), all codebooks of a site in one batched k-means. Records
    (keyed by the dense registry's tape keys) join the LUT registry on
    (layer, kind), for every bundle kind. A sample batch carries what the
    model's loss reads: "tokens", "frames" (enc-dec) or "embeds" (and "pos";
    under M-RoPE without it, 0..S-1 in all three streams, as the reference
    builds it). The expert sites never record (as in the reference), so
    their shared centroids keep their init."""
    dev = dense_params["embed"]["table"].device
    tape = tape_capture(max_rows=max_rows)
    with tape, torch.no_grad():
        for batch in sample_batches:
            bundle_dense.loss(dense_params, {k: v.to(dev) for k, v in batch.items()},
                              compute_dtype=torch.float32)

    dense_by_tape = {s.tape_key: s for s in bundle_dense.sites() if s.tape_key is not None}
    lut_by_site = {(s.layer, s.kind): s for s in bundle_lut.sites()}
    out = _copy_tree(lut_params)
    with torch.no_grad():
        for rec_key in list(tape.records):
            rows = tape.records.pop(rec_key)
            ds = dense_by_tape.get(rec_key)
            ls = None if ds is None else lut_by_site.get((ds.layer, ds.kind))
            if ls is None or ls.mode != Mode.LUT_TRAIN:
                continue                     # the site stays dense under the plan
            site = site_params(out, ls)
            _, k, v = site["centroids"].shape
            site["centroids"] = kmeans.kmeans_per_codebook(gen, torch.cat(rows), k=k, v=v,
                                                           iters=kmeans_iters)
    return out


def convert_dense_to_lut_train(bundle_dense: ModelBundle, dense_params: Any,
                               sample_batches: list[dict[str, torch.Tensor]],
                               gen: torch.Generator, **kw: Any) -> tuple[ModelBundle, Any]:
    """The offline pipeline: dense model -> soft-PQ-trainable LUT model on the
    dense params' device."""
    dev = dense_params["embed"]["table"].device
    bundle_lut = build_model(bundle_dense.arch, Mode.LUT_TRAIN)
    lut_params = bundle_lut.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    lut_params = graft_dense_to_lut(dense_params, lut_params)
    lut_params = kmeans_init_lut(bundle_dense, dense_params, bundle_lut, lut_params,
                                 sample_batches, gen, **kw)
    return bundle_lut, lut_params


def _no_centroids(base: str) -> ValueError:
    return ValueError(
        f"{base}: the deploy plan replaces this site but the trained checkpoint carries no "
        f"centroids for it — a deploy plan may only replace sites the TRAINED plan replaced "
        f"(derive sub-plans with LUTPlan.keeping_dense)")


def _global_path(spec) -> str:
    """A registry entry's path in `_global`'s view of the port's tree."""
    if spec.stack_index is None:
        return spec.path
    top = spec.path.split("/")[0]
    return f"segments/{spec.layer}/{spec.kind}" if top == "segments" else \
        f"{top}/{spec.stack_index}/{spec.kind}"


def _deploy_site(spec, want: dict[str, Any], src: Any) -> dict[str, Any]:
    """One LUT_INFER site's params from its LUT_TRAIN source: the table of
    the trained centroids and frozen `w` (an expert site's (E, D, F) weights
    share the codebooks: (E, C, K, F) tables), int8-quantized with the
    site's own LUTConfig (each expert on its own m-shared scale where the
    config asks for it)."""
    # a site trained with other K/V has centroids of another shape: as good as none
    if not isinstance(src, dict) or "centroids" not in src or \
            tuple(src["centroids"].shape) != tuple(want["centroids"].shape):
        raise _no_centroids(spec.path)
    qt = lut_layer.quantize_for(pq.build_table(src["centroids"], src["w"],
                                               stop_weight_grad=False), spec.lut)
    out = {"centroids": src["centroids"].float(), "table_q": qt.q, "table_scale": qt.scale}
    for name in ("table_q", "table_scale"):
        if tuple(out[name].shape) != tuple(want[name].shape):
            raise ValueError(
                f"{spec.path}/{name}: deployed shape {tuple(out[name].shape)} != model spec "
                f"{tuple(want[name].shape)} — the deploy plan's K/V/bits must match what the "
                f"site was trained with")
    if "b" in want:
        out["b"] = src["b"]
    return out


@torch.no_grad()
def deploy_lut_train_params(bundle_lut: ModelBundle, lut_params: Any, *,
                            plan: Any | None = None) -> tuple[ModelBundle, Any]:
    """LUT_TRAIN params -> LUT_INFER params (int8 tables, the weights dropped),
    for every bundle kind: one walk of the LUT_INFER tree, each replaced
    site's tables built and quantized with its own LUTConfig.

    `plan` (a LUTPlan) deploys the same training state under another plan: a
    site it replaces takes its tables from the trained centroids and frozen
    `w` (byte-identical to the trained plan's), a site it keeps dense takes
    the frozen `w` itself. A plan that replaces a site the trained plan left
    dense has no centroids to build from and raises ValueError; so does a
    LUTConfig whose table shape differs from what the site was trained with."""
    arch = bundle_lut.arch if plan is None else dataclasses.replace(bundle_lut.arch,
                                                                    lut_plan=plan)
    bundle_inf = build_model(arch, Mode.LUT_INFER)
    sites = {_global_path(s): s for s in bundle_inf.sites() if s.mode == Mode.LUT_INFER}

    def walk(want: Any, src: Any, path: str) -> Any:
        if isinstance(want, dict):
            if path in sites:
                return _deploy_site(sites[path], want, src)
            return {k: walk(v, src.get(k) if isinstance(src, dict) else None,
                            f"{path}/{k}" if path else k) for k, v in want.items()}
        if isinstance(want, list):
            return [walk(v, src[i] if isinstance(src, list) and i < len(src) else None,
                         f"{path}/{i}") for i, v in enumerate(want)]
        if not isinstance(src, torch.Tensor) or tuple(src.shape) != tuple(want.shape):
            raise KeyError(f"no source for deployed param {path}")
        return src

    specs = layer_specs(bundle_inf)
    out = walk(_global(specs), _global(lut_params), "")
    return bundle_inf, _regroup(out, specs)


def deploy_to_artifact(bundle_lut: ModelBundle, lut_params: Any, directory, *,
                       recipe: dict[str, Any] | None = None, target_plan: Any | None = None,
                       extra_plans: dict[str, Any] | None = None) -> tuple[ModelBundle, Any]:
    """Deploy LUT_TRAIN params and write the serving tree as a LUTArtifact
    (`serving.artifact.save_artifact`), the executed `recipe` in its manifest.
    `target_plan` deploys the main plan under an override (a sub-plan of the
    trained one); `extra_plans` maps further plan names to LUTPlans deployed
    from the same training state into the same artifact (the draft plan of
    speculative decoding). Returns the main plan's (bundle, params)."""
    from repro_torch.serving.artifact import save_artifact

    bundle_inf, inf_params = deploy_lut_train_params(bundle_lut, lut_params, plan=target_plan)
    extras = {name: deploy_lut_train_params(bundle_lut, lut_params, plan=p)
              for name, p in (extra_plans or {}).items()}
    save_artifact(directory, bundle_inf, inf_params, recipe=recipe, extra_plans=extras or None)
    return bundle_inf, inf_params
