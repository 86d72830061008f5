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

The passes walk the site registry (`ModelBundle.sites()`): tape records join
centroid leaves on (layer, kind), and each deployed table is built with its
own site's LUTConfig. Segments of the two models may group the layers
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
from repro_torch.weights import tree_map_ref

# LUT_TRAIN leaves with no dense source: they keep their fresh init through
# the graft. Any other unmatched leaf is a drifted tree and fails loudly.
_TRAINABLE_LUT_LEAVES = ("centroids", "log_t")


def _get(tree: Any, path: str) -> Any:
    for part in path.split("/"):
        if tree is None:
            return None
        tree = tree[int(part)] if isinstance(tree, list) else tree.get(part)
    return tree


def _layers(params: Any) -> list[dict[str, Any]]:
    """Every layer's param dict, in global layer order."""
    return [layer for seg in params["segments"] for layer in seg]


def _copy_tree(params: Any) -> Any:
    """New dicts and lists holding the same tensors."""
    return tree_map_ref(lambda _p, t: t, params)


def graft_dense_to_lut(dense_params: Any, lut_params: Any) -> Any:
    """The LUT_TRAIN tree with every leaf the dense model shares (w, b, norms,
    embedding) taken from the dense model; only centroids and log_t keep
    their init. Layers line up by global index."""
    dense_layers = _layers(dense_params)

    def pick(src: Any, path: str, leaf: torch.Tensor, where: str) -> torch.Tensor:
        if isinstance(src, torch.Tensor) and src.shape == leaf.shape:
            return src
        if path.rsplit("/", 1)[-1] in _TRAINABLE_LUT_LEAVES:
            return leaf
        raise ValueError(f"graft: no dense source for {where} (shape {tuple(leaf.shape)}): the "
                         f"dense and LUT models were built from different archs/plans")

    out = {k: tree_map_ref(lambda p, leaf, k=k: pick(_get(dense_params, p), p, leaf, p),
                           {k: v})[k]
           for k, v in lut_params.items() if k != "segments"}
    out["segments"] = []
    g = 0
    for seg_i, seg in enumerate(lut_params["segments"]):
        layers = []
        for layer in seg:
            src = dense_layers[g] if g < len(dense_layers) else {}
            layers.append(tree_map_ref(
                lambda p, leaf, src=src, g=g, seg_i=seg_i: pick(
                    _get(src, p), p, leaf, f"segments/{seg_i}/{p} (layer {g})"), layer))
            g += 1
        out["segments"].append(layers)
    return out


def kmeans_init_lut(bundle_dense: ModelBundle, dense_params: Any, bundle_lut: ModelBundle,
                    lut_params: Any, sample_batches: list[dict[str, torch.Tensor]],
                    gen: torch.Generator, *, kmeans_iters: int = 25,
                    max_rows: int = 4096) -> Any:
    """Capture the replaced sites' inputs under the original dense model
    (paper section 6.1) and k-means-init every centroid table of the LUT
    model (Eq. 1), all codebooks of a site in one batched k-means. Records
    (keyed by the dense registry's tape keys) join the LUT registry on
    (layer, kind)."""
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
            if ls.stack_index is None:
                site = _get(out, ls.path)
            else:
                seg_i = int(ls.path.split("/")[1])
                site = _get(out["segments"][seg_i][ls.stack_index], ls.kind)
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


@torch.no_grad()
def deploy_lut_train_params(bundle_lut: ModelBundle, lut_params: Any, *,
                            plan: Any | None = None) -> tuple[ModelBundle, Any]:
    """LUT_TRAIN params -> LUT_INFER params (int8 tables, the weights dropped).

    Every replaced site's tables are built and quantized with its own
    LUTConfig, all layers of a segment's site in one batched call. `plan` (a
    LUTPlan) deploys the same training state under another plan: a site it
    replaces takes its tables from the trained centroids and frozen `w`
    (byte-identical to the trained plan's), a site it keeps dense takes the
    frozen `w` itself. A plan that replaces a site the trained plan left
    dense has no centroids to build from and raises ValueError; so does a
    LUTConfig whose table shape differs from what the site was trained with."""
    arch = bundle_lut.arch if plan is None else dataclasses.replace(bundle_lut.arch,
                                                                    lut_plan=plan)
    bundle_inf = build_model(arch, Mode.LUT_INFER)
    specs = bundle_inf.param_specs()
    train_layers = _layers(lut_params)

    def top(path: str, spec) -> torch.Tensor:
        src = _get(lut_params, path)
        if src is None or tuple(src.shape) != tuple(spec.shape):
            raise KeyError(f"no source for deployed param {path}")
        return src

    out: dict[str, Any] = {k: tree_map_ref(lambda p, s: top(p, s), {k: v})[k]
                           for k, v in specs.items() if k != "segments"}
    out["segments"] = []
    lo = 0
    for seg_i, (count, _) in enumerate(bundle_inf.cfg.segments):
        src_layers = train_layers[lo: lo + count]
        sites = {s.kind: s for s in bundle_inf.sites()
                 if s.path.startswith(f"segments/{seg_i}/") and s.mode == Mode.LUT_INFER}
        tables = {}
        for kind, site in sites.items():
            site_specs = _get(specs["segments"][seg_i], kind)
            srcs = [_get(layer, kind) or {} for layer in src_layers]
            # a site trained with other K/V has centroids of another shape: as
            # good as none (the reference meets this leaf first, too)
            if any("centroids" not in s or tuple(s["centroids"].shape)
                   != tuple(site_specs["centroids"].shape[1:]) for s in srcs):
                raise _no_centroids(f"segments/{seg_i}/{kind}")
            p = torch.stack([s["centroids"] for s in srcs])
            w = torch.stack([s["w"] for s in srcs])
            qt = lut_layer.quantize_for(pq.build_table(p, w, stop_weight_grad=False), site.lut)
            for name, leaf in (("table_q", qt.q), ("table_scale", qt.scale)):
                want = tuple(site_specs[name].shape)
                if (count, *leaf.shape[1:]) != want:
                    raise ValueError(
                        f"segments/{seg_i}/{kind}/{name}: deployed shape "
                        f"{(count, *leaf.shape[1:])} != model spec {want} — the deploy plan's "
                        f"K/V/bits must match what the site was trained with")
            tables[kind] = qt

        def leaf(path: str, spec, j: int) -> torch.Tensor:
            base, name = path.rsplit("/", 1)
            if base in tables and name in ("table_q", "table_scale"):
                qt = tables[base]
                return (qt.q if name == "table_q" else qt.scale)[j]
            src = _get(src_layers[j], path)
            if src is None or tuple(src.shape) != tuple(spec.shape[1:]):
                raise KeyError(f"no source for deployed param segments/{seg_i}/{path}")
            return src.float() if name == "centroids" else src

        out["segments"].append([tree_map_ref(lambda p, s, j=j: leaf(p, s, j),
                                             specs["segments"][seg_i]) for j in range(count)])
        lo += count
    return bundle_inf, out


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
