"""Tensor-parallel serving of the MoE, SSM and hybrid families at tp 2, two
gloo ranks on the CPU, against the reference's unsharded and tp=2 engines
(2 forced host devices, as tests/test_torch_tp.py drives them) and the
port's unsharded engine.

Reduced arctic_480b (top-2 and the dense residual; layer 0 dense),
llama4_maverick_400b (top-1 and the shared expert), mamba2_370m and
zamba2_1p2b (its shared block invoked once), 2 layers each, written as
artifacts by the reference with `lut_use_kernel=True` (m-shared scales);
both packages serve them. Per arch: greedy tokens equal the reference's
unsharded and tp=2 engines' where the reference is sound (the SSM families
on prompts of exactly one prefill chunk: its chunked prefill is a known
fault past one), and the port's unsharded engine's on every prompt (two
chunks, ragged); the logits within 1e-4 of the port's unsharded engine's on
every rank; every LUT site's output (a column site's columns, in_proj's
head-aligned selection, a row site's reduced output) and every expert's
output the unsharded one's bytewise; the all-reduces per forward; the
paged engines of the three attention families. Also the layout of every
leaf at tp 2 and 4 at full published width against `ShardingRules` and the
named kept differences, the launcher's `--tp 2` on the SSM and hybrid
artifacts in batch and HTTP modes, and a known reference fault the port
keeps (the paged and dense MoE engines part at ragged prefill chunks)."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import urllib.request

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfg
from repro.core.amm import Mode as JMode
from repro.serving import artifact as jart
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.checkpoint.paths import flatten_tree
from repro_torch.configs import build_model, get_arch, reduce_arch
from repro_torch.core.amm import Mode
from repro_torch.distributed import tensor_parallel
from repro_torch.distributed.sharding import ShardingRules, site_roles
from repro_torch.serving.artifact import load_artifact
from repro_torch.serving.engine import ServingEngine
from tests._subproc import SRC
from tests._tp_ranks import FAMILY_ENGINE_KW, collect, serve_families, start_ranks

LOGIT_ATOL = 1e-4
ARCHS = ("arctic_480b", "llama4_maverick_400b", "mamba2_370m", "zamba2_1p2b")
RECURRENT = ("mamba2_370m", "zamba2_1p2b")
ATTENTION = ("arctic_480b", "llama4_maverick_400b", "zamba2_1p2b")
CHUNK = FAMILY_ENGINE_KW["prefill_chunk"]
# all-reduces of one forward at 2 layers: the vocab-sharded embedding, the
# gathered logits, and per layer: moe attention's o, the expert combine and
# the dense residual's or shared expert's down; mamba the gated norm's gather
# and out_proj; the hybrid's shared block (once) its o and down
REDUCES_PER_FORWARD = {"arctic_480b": 8, "llama4_maverick_400b": 8, "mamba2_370m": 6,
                       "zamba2_1p2b": 8}


def _requests(name: str) -> tuple[list, list]:
    """(requests the reference engines serve soundly, the port's further
    ones): one-chunk prompts and prompts of two chunks, ragged and short for
    the recurrent families; ragged prompts past one chunk for MoE (its
    caches are attention K/V only)."""
    rng = np.random.default_rng(7)
    vocab = jcfg.reduce_arch(jcfg.get_arch(name)).vocab
    if name in RECURRENT:
        ref = [(rng.integers(1, vocab, CHUNK).tolist(), 5) for _ in range(3)]
        more = [(rng.integers(1, vocab, n).tolist(), 4) for n in (16, 11, 5, 3)]
        return ref, more
    return [(rng.integers(1, vocab, n).tolist(), 5) for n in (8, 5, 13)], []


def _ref_tokens(bundle, params, reqs):
    eng = JServingEngine(bundle, params, autotune_lut=False, **{
        k: v for k, v in FAMILY_ENGINE_KW.items() if k != "autotune_lut"})
    for prompt, n in reqs:
        eng.submit(prompt, max_tokens=n)
    return [r.out_tokens for r in sorted(eng.run_until_done(), key=lambda r: r.rid)]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """{arch: {"art", "ref", "ref_tp", "ranks": [rank 0's serve_family
    result, rank 1's]}}."""
    root = tmp_path_factory.mktemp("tp_families")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_AUTOTUNE_CACHE", str(root / "autotune.json"))
        return _serve_all(root)


def _serve_all(root) -> dict:
    refs, out = {}, {}
    for name in ARCHS:
        arch = jcfg.reduce_arch(jcfg.get_arch(name), n_layers=2, lut_use_kernel=True)
        bundle = jcfg.build_model(arch, JMode.LUT_INFER)
        refs[name] = (bundle, bundle.init(jax.random.PRNGKey(0)))
        out[name] = {"art": str(root / name), "reqs": _requests(name)}
        jart.save_artifact(out[name]["art"], bundle, refs[name][1], autotune_snapshot=False)
    ref_reqs = {name: out[name]["reqs"][0] for name in ARCHS}
    code = textwrap.dedent(f"""
        import json
        from repro.launch.mesh import make_host_mesh
        from repro.serving.artifact import load_artifact
        from repro.serving.engine import ServingEngine
        res = {{}}
        mesh = make_host_mesh(data=1, model=2)
        for name, reqs in {ref_reqs!r}.items():
            art = load_artifact({str(root)!r} + "/" + name, restore_autotune=False)
            eng = ServingEngine(art.bundle, art.params, n_slots=2, max_seq=32,
                                prefill_chunk={CHUNK}, autotune_lut=False, mesh=mesh)
            for prompt, n in reqs:
                eng.submit(prompt, max_tokens=n)
            res[name] = [r.out_tokens for r in sorted(eng.run_until_done(),
                                                      key=lambda r: r.rid)]
        print("REF_TP=" + json.dumps(res))
        """)
    ref_tp = subprocess.Popen(
        [sys.executable, "-c", code], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC,
                 XLA_FLAGS="--xla_force_host_platform_device_count=2"))
    ranks = start_ranks(serve_families, 2, {
        name: (out[name]["art"], sum(out[name]["reqs"], []), name in ATTENTION)
        for name in ARCHS})
    for name, (bundle, params) in refs.items():
        out[name]["ref"] = _ref_tokens(bundle, params, ref_reqs[name])
    per_rank = collect(ranks, timeout=600)
    stdout, stderr = ref_tp.communicate(timeout=600)
    assert ref_tp.returncode == 0, stderr
    line = next(ln for ln in stdout.splitlines() if ln.startswith("REF_TP="))
    for name, toks in json.loads(line[len("REF_TP="):]).items():
        out[name]["ref_tp"] = toks
        out[name]["ranks"] = [r[name] for r in per_rank]
    return out


@pytest.mark.parametrize("name", ARCHS)
def test_tp2_tokens_equal_the_reference_and_the_unsharded_port(served, name):
    got = served[name]
    ref_reqs, more = got["reqs"]
    lead = got["ranks"][0]
    toks = lead["tp"]["dense"]["tokens"]
    assert toks[:len(ref_reqs)] == got["ref"] == got["ref_tp"], name
    assert toks == lead["plain"]["dense"]["tokens"], name
    assert [len(t) for t in toks] == [n for _, n in ref_reqs + more]
    if name in ATTENTION:
        assert lead["tp"]["paged"]["tokens"] == lead["plain"]["paged"]["tokens"] == toks


@pytest.mark.parametrize("name", ARCHS)
def test_tp2_logits_within_bound_on_every_rank(served, name):
    ranks = served[name]["ranks"]
    for case in ranks[0]["tp"]:
        want = ranks[0]["plain"][case]["logits"]
        for rank in ranks:
            got = rank["tp"][case]["logits"]
            assert len(got) == len(want) > 0
            for (g, _), (w, _) in zip(got, want):
                assert g.shape == w.shape
                assert float(np.abs(g - w).max()) <= LOGIT_ATOL, (name, case)
        for (a, _), (b, _) in zip(ranks[0]["tp"][case]["logits"], ranks[1]["tp"][case]["logits"]):
            assert np.array_equal(a, b)


def _in_proj_blocks(cuts: dict):
    return next(c[1] for p, c in cuts.items() if p.endswith("mamba/in_proj/table_q"))


@pytest.mark.parametrize("name", ARCHS)
def test_tp2_lut_sites_bytewise(served, name):
    """Every LUT site's output on each rank is the unsharded site's
    bytewise: a column site's columns (in_proj's head-aligned selection), a
    row site's reduced output, a replicated site's whole output."""
    ranks = served[name]["ranks"]
    n_lut = dict.fromkeys(("col", "row", "in_proj"), 0)
    for r, rank in enumerate(ranks):
        for case in rank["tp"]:
            rec = rank["tp"][case]
            want = ranks[0]["plain"][case]["sites"]
            got = rec["sites"]
            assert [(n, m) for n, m, _, _ in got] == [(n, m) for n, m, _, _ in want]
            for (site, mode, role, y), (_, _, _, y0) in zip(got, want):
                if site == "mamba/in_proj":
                    y0 = tensor_parallel.cut(torch.from_numpy(y0), (y0.ndim - 1, _in_proj_blocks(
                        rec["cuts"])), r, 2).numpy()
                elif role.startswith("col"):
                    m = y.shape[-1]
                    y0 = y0[..., r * m: (r + 1) * m] if role == "col" else y0
                assert y.shape == y0.shape, (site, role)
                if mode == Mode.LUT_INFER.value:
                    assert np.array_equal(y, y0), (name, case, r, site, role)
                    n_lut["in_proj" if site == "mamba/in_proj" else role or "col"] += 1
                else:                 # dense sites: matmuls of another shape or order
                    np.testing.assert_allclose(y, y0, rtol=1e-5, atol=1e-5)
    assert n_lut["row"] > 0 and (n_lut["in_proj"] > 0 if name in RECURRENT else n_lut["col"] > 0)


@pytest.mark.parametrize("name", ("arctic_480b", "llama4_maverick_400b"))
def test_tp2_each_expert_output_bytewise(served, name):
    """Rank r runs experts [r E/2, (r+1) E/2) of every expert site call:
    each one's output is the unsharded site's on the same input bytewise
    (layer 0's dense experts and layer 1's LUT ones, the whole params of
    the artifact), and together the ranks run the experts the unsharded
    engine ran at that call."""
    from repro_torch.models import moe

    ranks = served[name]["ranks"]
    art = load_artifact(served[name]["art"], device="cpu", restore_autotune=False)
    segs = art.bundle.cfg.segments
    layers = [(i, j) for i, (count, _) in enumerate(segs) for j in range(count)]
    want = {at: set(ids.tolist()) for at, _, ids, _, _ in ranks[0]["plain"]["dense"]["experts"]}
    ran: dict = {at: set() for at in want}
    for r, rank in enumerate(ranks):
        calls = rank["tp"]["dense"]["experts"]
        assert calls
        for (call, k), n_local, ids, x, y in calls:
            i, j = layers[(call - 1) % len(layers)]
            site = ("gate", "up", "down")[k - 1]
            full = moe.expert_linear(getattr(segs[i][1].moe, site),
                                     art.params["segments"][i][j]["moe"][site],
                                     torch.from_numpy(x), torch.from_numpy(ids) + r * n_local)
            assert torch.equal(torch.from_numpy(y), full), (name, call, site, r)
            ran[(call, k)] |= set((ids + r * n_local).tolist())
    assert ran == want
    # the combined output, all-reduced in fp32: the unsharded layer's on the
    # same input within fp32 rounding (the sum of a token's top-k terms across
    # ranks, where the unsharded layer sums them in one contraction)
    for call, x, y in ranks[0]["tp"]["dense"]["moe_layers"]:
        i, j = layers[(call - 1) % len(layers)]
        full, _ = moe.moe(segs[i][1].moe, art.params["segments"][i][j]["moe"],
                          torch.from_numpy(x))
        np.testing.assert_allclose(y, full.numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ARCHS)
def test_tp2_collectives_caches_and_artifact_shards(served, name):
    ranks = served[name]["ranks"]
    rec = ranks[1]["tp"]["dense"]
    st = rec["stats"]
    forwards = st["prefill_forwards"] + st["decode_forwards"]
    assert forwards > 0
    assert rec["counters"]["all_reduce"] == REDUCES_PER_FORWARD[name] * forwards
    assert all(r["artifact_shards_equal"] for r in ranks)
    shapes = rec["cache_shapes"]
    if name in RECURRENT:
        # reduced: d_inner 256, 16 SSD heads of 16, N 16, one group: a rank's
        # 8 heads and 128 + 2 * 16 conv channels
        assert shapes["ssm"][2] == 8 and shapes["conv"][-1] == 128 + 32
        assert rec["kept"] == ("ssm_heads",)
    else:
        assert rec["kept"] == ("experts_over_model",)
    if name in ATTENTION:
        # every attention cache written (the hybrid's shared block ran), on both ranks
        assert all(all(r["tp"][case]["kv_written"]) and r["tp"][case]["kv_written"]
                   for r in ranks for case in ("dense", "paged"))
        kv = jcfg.reduce_arch(jcfg.get_arch(name)).n_kv_heads
        assert ranks[0]["tp"]["paged"]["cache_shapes"]["k_pool"][3] == kv // 2


# ---------------------------------------------------------------------------
# the layout at full published width, tp 2 and 4
# ---------------------------------------------------------------------------

def _kept(path: str) -> str | None:
    """The kept difference a leaf's cut belongs to, by its path."""
    if any(f"/moe/{k}/" in path for k in ("gate", "up", "down", "router")):
        return "experts_over_model"
    if "/mamba/" in path and path.rsplit("/", 1)[1] != "norm":
        leaf = path.split("/mamba/", 1)[1]
        if leaf.startswith(("in_proj/", "conv_", "dt_bias", "A_log", "D")):
            return "ssm_heads"
    return None


@pytest.mark.parametrize("tp", (2, 4))
@pytest.mark.parametrize("name", ARCHS)
def test_layout_of_every_leaf_follows_the_rules_or_a_kept_difference(name, tp):
    """Every param leaf of the LUT_INFER and DENSE trees at full width: a
    leaf cut in tp equal parts is cut on the dim the spec puts over "model";
    a scale or bias goes with its table's columns or codebooks; a leaf the
    spec shards and the layout does not belongs to a site left replicated
    (no column/row pair: the hybrid's fuse and out) or to a named kept
    difference: the experts (E over "data" in the spec, their shared
    codebooks and the router replicated) and the mamba2 block's
    selections.
    Each rank's part of every leaf has the shape of the local bundle's."""
    for mode in (Mode.LUT_INFER, Mode.DENSE):
        bundle = build_model(get_arch(name), mode)
        rules = ShardingRules(model=tp)
        lay = tensor_parallel.layout(bundle, rules)
        local = tensor_parallel.local_bundle(bundle, lay)
        specs = flatten_tree(bundle.param_specs())
        local_specs = flatten_tree(local.param_specs())
        roles = site_roles(bundle)
        for path, leaf in specs.items():
            spec = rules.param_spec(path, tuple(leaf.shape), site_roles=roles)
            off = 1 if path.startswith(("segments/", "mamba_stack/")) else 0
            c = lay.cuts.get(path)
            kept = _kept(path)
            if kept is not None:
                assert kept in lay.kept, (path, lay.kept)
                if kept == "experts_over_model" and c is not None:
                    # E, where the spec puts it over "data" (a scale: replicated)
                    assert c == (0, None) and spec[off] in ("data", None), (path, spec)
            elif c is not None and path.endswith(("/table_scale", "/b")):
                # the spec replicates a scale and a bias (tiny); a rank holds the
                # part that goes with its columns or codebooks of the table
                site = path.rsplit("/", 1)[0]
                table = lay.cuts.get(f"{site}/table_q") or lay.cuts[f"{site}/w"]
                assert c[1] == table[1] and c[0] == (0 if path.endswith("/b") else table[0])
            elif c is not None:
                assert c[1] is None and spec[off + c[0]] == "model", (path, c, spec)
            elif "model" in spec:
                site = path.rsplit("/", 1)[0]
                assert site in ("shared/fuse", "shared/out"), (path, spec)
            want = list(local_specs[path].shape)
            if path == "embed/table" and lay.vocab:    # the configs keep the whole vocab
                want[0] //= tp
            for r in range(tp):
                part = tensor_parallel.cut_stacked(
                    path, torch.empty(tuple(leaf.shape), dtype=leaf.dtype, device="meta"), lay, r)
                assert list(part.shape) == want, (path, r)
        if bundle.arch.family == "moe":
            assert "experts_over_model" in lay.kept
            assert sum(role == "ep" for role in lay.roles.values()) == 3 * len(
                [b for _, b in bundle.cfg.segments if b.kind == "moe"])
        else:
            assert "ssm_heads" in lay.kept


def test_rank_kernel_signatures_at_full_width():
    """mamba2_370m's in_proj at tp 2 is M = 2*1024 + 2*128 + 16 = 2320 and
    zamba2_1p2b's 4096 + 128 + 32 = 4256, both multiples of 16; a rank's
    kernel signatures carry them beside out_proj's C / 2 in float32. The
    expert sites launch no kernel: arctic_480b's rank signatures hold none
    of theirs (moe/gate (4864, 224), moe/down (7168, 152))."""
    for name, m in (("mamba2_370m", 2320), ("zamba2_1p2b", 4256)):
        bundle = build_model(dataclasses.replace(get_arch(name), lut_use_kernel=True),
                             Mode.LUT_INFER)
        lay = tensor_parallel.layout(bundle, ShardingRules(model=2))
        local = tensor_parallel.local_bundle(bundle, lay)
        d, di = bundle.arch.d_model, bundle.arch.d_inner
        sigs = tensor_parallel.kernel_signatures(local, lay, "bfloat16")
        assert m % 16 == 0 and (m, d // 32, 16, 32, "bfloat16") in sigs, sigs
        assert (d, di // 32 // 2, 16, 32, "float32") in sigs, sigs
    bundle = build_model(dataclasses.replace(get_arch("arctic_480b"), lut_use_kernel=True),
                         Mode.LUT_INFER)
    lay = tensor_parallel.layout(bundle, ShardingRules(model=2))
    local = tensor_parallel.local_bundle(bundle, lay)
    sigs = {s[:2] for s in tensor_parallel.kernel_signatures(local, lay, "float32")}
    assert sigs and not sigs & {(4864, 224), (7168, 152)}, sigs
    assert local.cfg.segments[-1][1].moe.gate.n_experts == 64


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch_batch(art: str, *extra: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                             "--artifact", art, "--requests", "3", "--slots", "2", "--max-seq",
                             "64", "--prefill-chunk", "8", "--max-tokens", "5", *extra],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))


@pytest.mark.parametrize("name", RECURRENT)
def test_launcher_tp2_serves_the_family_with_tp1_tokens(served, name):
    procs = [_launch_batch(served[name]["art"], *extra) for extra in ([], ["--tp", "2"])]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    reqs = [[ln for ln in out.splitlines() if ln.strip().startswith("req ")] for out, _ in outs]
    assert len(reqs[0]) == 3 and reqs[0] == reqs[1]
    assert "tp=2 over gloo" in outs[1][0] and f"({name})" in outs[1][0]


def test_launcher_tp2_http_serves_the_hybrid(served):
    """HTTP mode at tp 2 on the hybrid artifact: rank 0 serves /generate, the
    follower runs its forwards; SIGTERM drains and every rank exits."""
    art = served["zamba2_1p2b"]["art"]
    proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
                             "--artifact", art, "--tp", "2", "--port", "0", "--max-seq", "64",
                             "--prefill-chunk", "8"], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True,
                            env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
    prompt = list(range(3, 14))                      # ragged over two chunks
    try:
        line = proc.stdout.readline()
        assert "tp=2 over gloo" in line, line
        port = int(line.split("http://127.0.0.1:")[1].split()[0])
        body = json.dumps({"prompt": prompt, "max_tokens": 5}).encode()
        with urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=body), timeout=60) as r:
            got = json.loads(r.read())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
    loaded = load_artifact(art, device="cpu", restore_autotune=False)
    eng = ServingEngine(loaded.bundle, loaded.params, n_slots=4, max_seq=64, prefill_chunk=8,
                        autotune_lut=False, device="cpu")
    eng.submit(prompt, max_tokens=5)
    assert got["status"] == "ok" and got["tokens"] == eng.run_until_done()[0].out_tokens


def test_paged_and_dense_moe_engines_part_on_ragged_chunks_in_both_packages():
    """A known reference fault the port keeps for parity (ROADMAP): with
    top-2 routing, the padded positions of a ragged prefill chunk are routed
    too and take expert capacity before the chunk's second choices; the
    dense engine computes them from the chunk's slab, the paged engine from
    the garbage page, so the two engines' tokens part. The port's engines
    give the reference's engines' tokens, paged and dense."""
    from repro_torch.weights import params_from_numpy

    arch = jcfg.reduce_arch(jcfg.get_arch("arctic_480b"), n_layers=2, lut_use_kernel=True)
    jb = jcfg.build_model(arch, JMode.LUT_INFER)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = build_model(reduce_arch(get_arch("arctic_480b"), n_layers=2, lut_use_kernel=True),
                     Mode.LUT_INFER)
    tp = params_from_numpy(tb, jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(20)
    prompts = [rng.integers(0, arch.vocab, n).tolist() for n in (32, 64, 45, 17, 32, 50, 9, 60)]
    kw = dict(n_slots=4, max_seq=256, prefill_chunk=32, autotune_lut=False)
    out = {}
    for paged in (False, True):
        pk = dict(paged=True, page_size=16) if paged else {}
        for name, eng in (("ref", JServingEngine(jb, jp, **kw, **pk)),
                          ("port", ServingEngine(tb, tp, device="cpu", **kw, **pk))):
            for prompt in prompts:
                eng.submit(prompt, max_tokens=16)
            out[name, paged] = [r.out_tokens for r in
                                sorted(eng.run_until_done(), key=lambda r: r.rid)]
    assert out["port", False] == out["ref", False]
    assert out["port", True] == out["ref", True]
    assert out["port", True] != out["port", False]
