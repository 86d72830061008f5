"""Deployment artifacts between the two packages: the reference writes, the
port loads, and the port writes, the reference loads, with byte-equal leaves;
the loader's migrations, fallbacks and rejections; and one artifact served by
both engines with the same pinned kernel versions."""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.checkpoint.checkpointer import flatten_tree as jflatten
from repro.core import convert
from repro.core.amm import Mode as JMode
from repro.kernels import autotune as jautotune
from repro.serving import artifact as jart
from repro.serving.engine import ServingEngine as JServingEngine
from repro.serving.sampling import SamplingParams as JSamplingParams
from repro_torch.checkpoint.paths import flatten_tree
from repro_torch.kernels import autotune, counters, ref
from repro_torch.serving import artifact
from repro_torch.serving.engine import ServingEngine, lut_kernel_signatures
from repro_torch.serving.sampling import SamplingParams
from repro_torch.testing import site_params
from repro_torch.weights import params_to_numpy


def _ref_bundle(arch_id="qwen3_1p7b", param_dtype="float32", n_layers=2, key=0, **kw):
    arch = jcfg.reduce_arch(jcfg.get_arch(arch_id), n_layers=n_layers, lut_use_kernel=True,
                            param_dtype=param_dtype, **kw)
    bundle = jcfg.build_model(arch, JMode.LUT_INFER)
    return bundle, bundle.init(jax.random.PRNGKey(key))


def _ref_leaves(params) -> dict[str, np.ndarray]:
    """{path: array} of reference params, bfloat16 as its uint16 bits."""
    out = {}
    for k, a in jflatten(jax.tree.map(np.asarray, params)).items():
        out[k] = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
    return out


def _assert_same_leaves(port_art, ref_params):
    got = flatten_tree(params_to_numpy(port_art.bundle, port_art.params))
    want = _ref_leaves(ref_params)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


# every arch the port builds: the dense family, moe, ssm, hybrid, enc-dec and vlm
ARCHS = ["qwen3_1p7b", "llama3_8b", "bert_base", "command_r_35b", "minitron_8b",
         "mamba2_370m", "zamba2_1p2b", "arctic_480b", "llama4_maverick_400b",
         "whisper_tiny", "qwen2_vl_7b"]
EXPERT_KINDS = ("moe/gate", "moe/up", "moe/down")


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_reference_artifact_loads_byte_equal(tmp_path, arch_id, param_dtype):
    bundle, params = _ref_bundle(arch_id, param_dtype)
    jart.save_artifact(tmp_path / "art", bundle, params)
    art = artifact.load_artifact(tmp_path / "art", device="cpu")
    assert art.arch_name == arch_id and art.plan_names == ["target"]
    assert art.bundle.mode.value == "lut_infer" and art.bundle.kind == bundle.kind
    # JSON lists come back as the arch's tuples (M-RoPE's sections)
    assert art.bundle.arch.mrope_sections == bundle.arch.mrope_sections
    assert type(art.bundle.arch.mrope_sections) is tuple
    # the m-shared kernel layout really is what the reference deployed
    spec = [s for s in art.bundle.lut_sites() if s.kind not in EXPERT_KINDS][-1]
    site = site_params(art.params, spec)
    assert site["table_q"].dtype == torch.int8 and site["table_scale"].shape[0] == 1
    for spec in art.bundle.lut_sites():
        if spec.kind in EXPERT_KINDS:
            # per-expert int8 tables over the layer's shared codebooks
            site = site_params(art.params, spec)
            assert site["table_q"].shape[0] == art.bundle.arch.n_experts
            assert site["table_scale"].shape == (art.bundle.arch.n_experts, 1, 1, spec.d_out)
    _assert_same_leaves(art, jart.load_artifact(tmp_path / "art").params)


@pytest.mark.parametrize("arch_id", ARCHS)
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_port_artifact_loads_in_reference_byte_equal(tmp_path, param_dtype, arch_id):
    bundle, params = _ref_bundle(arch_id, param_dtype, n_layers=3)
    jart.save_artifact(tmp_path / "ref", bundle, params)
    art = artifact.load_artifact(tmp_path / "ref", device="cpu")
    artifact.save_artifact(tmp_path / "port", art.bundle, art.params)
    back = jart.load_artifact(tmp_path / "port")
    assert back.bundle.arch == bundle.arch
    want, got = _ref_leaves(params), _ref_leaves(back.params)
    assert list(got) == list(want)
    assert all(got[k].dtype == want[k].dtype and got[k].tobytes() == want[k].tobytes()
               for k in want)
    # the two manifests agree field by field, tree structure included
    m_ref = json.loads((tmp_path / "ref" / "manifest.json").read_text())
    m_port = json.loads((tmp_path / "port" / "manifest.json").read_text())
    assert m_port == m_ref


def _two_plan_setup(key):
    """The reference's two-plan deployment: one LUT_TRAIN state deployed as
    the full plan ('draft') and its attn-kept-dense sub-plan ('target')."""
    arch = jcfg.reduce_arch(jcfg.get_arch("qwen3_1p7b"), n_layers=2, d_model=64, vocab=128,
                            d_ff=128)
    blut = jcfg.build_model(arch, JMode.LUT_TRAIN)
    lparams = blut.init(jax.random.PRNGKey(key))
    trained = jcfg.effective_plan(arch)
    tb, tp = convert.deploy_lut_train_params(blut, lparams, plan=trained.keeping_dense("attn/*"))
    db, dp = convert.deploy_lut_train_params(blut, lparams, plan=trained)
    return (tb, tp), (db, dp)


def test_reference_two_plan_artifact_both_ways(tmp_path):
    (tb, tp), (db, dp) = _two_plan_setup(0)
    jart.save_artifact(tmp_path / "ref", tb, tp, extra_plans={"draft": (db, dp)})
    target = artifact.load_artifact(tmp_path / "ref", device="cpu")
    draft = artifact.load_artifact(tmp_path / "ref", plan="draft", device="cpu")
    assert target.plan_names == ["target", "draft"] and draft.plan_name == "draft"
    _assert_same_leaves(target, tp)
    _assert_same_leaves(draft, dp)
    with pytest.raises(ValueError, match=r"no plan 'tiny'.*draft"):
        artifact.load_artifact(tmp_path / "ref", plan="tiny", device="cpu")

    # the port writes the same two plans; the reference reads both, and
    # leaves the plans share are stored once
    artifact.save_artifact(tmp_path / "port", target.bundle, target.params,
                           extra_plans={"draft": (draft.bundle, draft.params)})
    m = json.loads((tmp_path / "port" / "manifest.json").read_text())
    keys = [r["key"] for r in m["plans"]["draft"]["leaves"].values()]
    assert any(not k.startswith("plan.") for k in keys) and any(k.startswith("plan.") for k in keys)
    assert m["plans"] == json.loads((tmp_path / "ref" / "manifest.json").read_text())["plans"]
    for plan, want in (("target", tp), ("draft", dp)):
        back = jart.load_artifact(tmp_path / "port", plan=plan)
        got_l, want_l = _ref_leaves(back.params), _ref_leaves(want)
        assert all(got_l[k].tobytes() == want_l[k].tobytes() for k in want_l)
    with pytest.raises(ValueError, match="reserved"):
        artifact.save_artifact(tmp_path / "x", target.bundle, target.params,
                               extra_plans={"target": (draft.bundle, draft.params)})
    assert "draft" in artifact.describe_artifact(tmp_path / "port")


def test_v1_and_v2_manifests_migrate(tmp_path):
    bundle, params = _ref_bundle(d_model=64, vocab=64, d_ff=128)
    d = jart.save_artifact(tmp_path / "art", bundle, params)
    manifest = json.loads((d / "manifest.json").read_text())
    # v2: no extra plans; a named plan fails with the single-plan reason
    (d / "manifest.json").write_text(json.dumps(dict(manifest, version=2)))
    art = artifact.load_artifact(d, device="cpu")
    assert art.plan_names == ["target"]
    _assert_same_leaves(art, params)
    with pytest.raises(ValueError, match="single-plan"):
        artifact.load_artifact(d, plan="draft", device="cpu")
    # v1: no plan, the arch's legacy lut_policy resolves it
    v1 = dict(manifest, version=1, arch={k: v for k, v in manifest["arch"].items()
                                         if k != "lut_plan"})
    v1.pop("plan")
    (d / "manifest.json").write_text(json.dumps(v1))
    art = artifact.load_artifact(d, device="cpu")
    assert art.bundle.arch.lut_plan is None and art.bundle.arch.name == "qwen3_1p7b"
    _assert_same_leaves(art, params)


def test_old_fallback_and_redeploy(tmp_path):
    bundle, params = _ref_bundle()
    jart.save_artifact(tmp_path / "art", bundle, params)
    art = artifact.load_artifact(tmp_path / "art", device="cpu")
    # a crash between the two replaces: <dir> gone, the previous at <dir>.old
    shutil.move(tmp_path / "art", tmp_path / "art.old")
    assert artifact.check_artifact_dir(tmp_path / "art")["version"] == 3
    back = artifact.load_artifact(tmp_path / "art", device="cpu")
    assert back.path == tmp_path / "art.old"
    _assert_same_leaves(back, params)
    # a re-deploy by the port commits, and leaves no .old or .tmp behind
    artifact.save_artifact(tmp_path / "art", art.bundle, art.params)
    artifact.save_artifact(tmp_path / "art", art.bundle, art.params)
    assert not (tmp_path / "art.tmp").exists() and not (tmp_path / "art.old").exists()
    _assert_same_leaves(artifact.load_artifact(tmp_path / "art", device="cpu"), params)


def test_loader_rejections(tmp_path):
    bundle, params = _ref_bundle()
    d = jart.save_artifact(tmp_path / "art", bundle, params)
    manifest = json.loads((d / "manifest.json").read_text())

    def load_with(m):
        (d / "manifest.json").write_text(json.dumps(m))
        return artifact.load_artifact(d, device="cpu")

    with pytest.raises(FileNotFoundError):
        artifact.load_artifact(tmp_path / "nope", device="cpu")
    with pytest.raises(ValueError, match="format"):
        load_with(dict(manifest, format="other"))
    with pytest.raises(ValueError, match="version"):
        load_with(dict(manifest, version=99))
    with pytest.raises(ValueError, match="plan"):
        load_with(dict(manifest, plan=dict(manifest["plan"], rules=[])))
    with pytest.raises(ValueError, match="kind"):
        load_with(dict(manifest, kind="encdec"))
    with pytest.raises(ValueError):          # arch no longer matches the stored arrays
        load_with(dict(manifest, arch=dict(manifest["arch"], d_model=256)))
    leaves = dict(manifest["leaves"])
    path = "segments/1/mlp/down/table_q"
    with pytest.raises(ValueError, match="manifest"):
        load_with(dict(manifest, leaves={**leaves, path: dict(leaves[path], dtype="int16")}))
    with pytest.raises(ValueError, match="mismatch"):
        load_with(dict(manifest, leaves={k: v for k, v in leaves.items() if k != path}))
    # an extra array in the payload, and a leaf whose dtype the model does not take
    with np.load(d / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files}
    np.savez(d / "arrays.npz", **arrays, stray=np.zeros(3))
    with pytest.raises(ValueError, match="extra"):
        load_with(manifest)
    arrays[path] = arrays[path].astype(np.int16)
    np.savez(d / "arrays.npz", **arrays)
    with pytest.raises(ValueError, match="model"):
        load_with(dict(manifest, leaves={**leaves, path: dict(leaves[path], dtype="int16")}))
    (d / "manifest.json").write_text("{not json")
    with pytest.raises(ValueError, match="unreadable"):
        artifact.check_artifact_dir(d)


def test_snapshot_ships_site_records_and_restores_with_precedence(tmp_path):
    bundle, params = _ref_bundle()
    jart.save_artifact(tmp_path / "ref", bundle, params)
    art = artifact.load_artifact(tmp_path / "ref", device="cpu")
    (m, c, k, v) = lut_kernel_signatures(art.bundle)[0]
    cache = autotune.get_cache()
    on_card = autotune.shape_key("lut_amm", 4, m, c, k, v, "float32", "cuda-sm90")
    enc = autotune.shape_key("encode", 4, 0, c, k, v, "float32", "cuda-sm90")
    other = autotune.shape_key("lut_amm", 4, 999, c, k, v, "float32", "cuda-sm90")
    rec = {"block_n": 8, "block_m": 16, "block_c": c, "version": 1, "measured": True,
           "source": "cuda_events"}
    for key in (on_card, enc, other):
        cache.put(key, dict(rec))
    artifact.save_artifact(tmp_path / "port", art.bundle, art.params)
    snap = json.loads((tmp_path / "port" / "autotune.json").read_text())["entries"]
    assert on_card in snap and enc in snap and other not in snap

    # a fresh process: the snapshot fills holes, a measured snapshot record
    # replaces an analytic live one, never a measured one
    cache._entries = {}
    cache.put(on_card, dict(rec, version=2, measured=False, source="roofline_model"))
    cache.put(enc, dict(rec, block_c=1, measured=True))
    assert artifact.restore_autotune_snapshot(tmp_path / "port") == 1
    assert cache.get(on_card)["version"] == 1 and cache.get(enc)["block_c"] == 1
    assert artifact.load_artifact(tmp_path / "port", device="cpu") is not None
    assert autotune.kernel_choice(4, m, c, k, v, backend="cuda-sm90")[0] == 1


# ---------------------------------------------------------------------------
# one artifact, two engines, the same pinned kernel version at every site
# ---------------------------------------------------------------------------

PROMPTS = [[5, 9, 2], [11, 3, 8, 13, 21, 34, 1, 7], [40, 41, 42, 43, 44, 45, 46, 47, 48],
           [2, 4, 6, 8, 10]]
ENGINE = dict(n_slots=2, max_seq=32, prefill_chunk=4)
SAMPLED = {1: (0.8, 50, 0.9, 11), 3: (1.2, 0, 0.8, 12)}   # rid -> temperature, top_k, top_p, seed


def _pin(version, bundle, tb):
    """Records that pin `version` at every LUT site at both engine shapes:
    the reference's (backend cpu, its heuristic tiling) and the port's."""
    jcache, tcache = jautotune.get_cache(), autotune.get_cache()
    counts = [ENGINE["n_slots"], ENGINE["n_slots"] * ENGINE["prefill_chunk"]]
    for m, c, k, v in lut_kernel_signatures(tb):
        for n in counts:
            kind = "fused" if version == 3 else "lut_amm"
            cfg = jautotune.heuristic(kind, n, m, c, k, v)
            jcache.put(jautotune.shape_key("lut_amm", n, m, c, k, v, "float32", "cpu"),
                       {**cfg.as_dict(), "version": version, "measured": False})
            tcache.put(autotune.shape_key("lut_amm", n, m, c, k, v, "float32", "torch-cpu"),
                       {"block_n": 0, "block_m": 0, "block_c": 0, "version": version,
                        "measured": False})


def _serve(eng, sampling_cls):
    for i, p in enumerate(PROMPTS):
        if i in SAMPLED:
            t, k, tp, seed = SAMPLED[i]
            eng.submit(p, max_tokens=5, sampling=sampling_cls(temperature=t, top_k=k, top_p=tp,
                                                              seed=seed))
        else:
            eng.submit(p, max_tokens=5)
    done = sorted(eng.run_until_done(), key=lambda r: r.rid)
    return [r.out_tokens for r in done], [r.status for r in done], eng.stats()


@pytest.mark.parametrize("version", [1, 2, 3])
def test_engines_serve_one_artifact_alike(tmp_path, version):
    """Greedy and sampled tokens, statuses and forward counts agree. Both
    engines run the pinned version (the reference in interpret mode, the port
    through its plain versions); no token here sits on a near-tie, so every
    token is equal."""
    bundle, params = _ref_bundle(n_layers=2)
    jart.save_artifact(tmp_path / "art", bundle, params, autotune_snapshot=False)
    jloaded = jart.load_artifact(tmp_path / "art")
    tloaded = artifact.load_artifact(tmp_path / "art", device="cpu")
    _pin(version, jloaded.bundle, tloaded.bundle)
    jeng = JServingEngine(jloaded.bundle, jloaded.params, **ENGINE)
    teng = ServingEngine(tloaded.bundle, tloaded.params, device="cpu", **ENGINE)
    assert jeng.n_lut_shapes_tuned == 0 and teng.n_lut_shapes_tuned == 0   # pinned, not tuned
    jtok, jstat, js = _serve(jeng, JSamplingParams)
    counters.reset()
    ttok, tstat, ts = _serve(teng, SamplingParams)
    plain = {1: "lut_amm_v1_plain", 2: "lut_amm_v2_plain", 3: "fused_decode_plain"}[version]
    assert ref.calls[plain] > 0 and counters.plain_calls() == ref.calls[plain]
    assert ttok == jtok and tstat == jstat == ["ok"] * len(PROMPTS)
    for key in ("prefill_forwards", "decode_forwards", "prefill_tokens", "decode_tokens",
                "completed", "steps"):
        assert ts[key] == js[key], key
