"""The port's kernel autotuner: key format, record precedence, isolation from
the reference's TPU/CPU records, the cache file, and the measured path with
a fake timer."""

import json

import pytest
import torch

from repro import configs as jcfg
from repro.kernels import autotune as jautotune
from repro_torch import configs as tcfg
from repro_torch.kernels import autotune, measure, ops, ref
from repro_torch.serving.engine import ServingEngine, lut_kernel_signatures, warm_lut_autotune
from repro_torch.testing import RAGGED

SIG = (2048, 64, 16, 32)          # qwen3_1p7b q/o at lut_v = 32: (M, C, K, V)
DOWN = (2048, 192, 16, 32)


def _rec(version, measured=False, **blocks):
    return {"block_n": 8, "block_m": 0, "block_c": 0, **blocks, "version": version,
            "measured": measured, "source": "cuda_events" if measured else "roofline_model"}


def test_key_format_is_the_references():
    args = ("lut_amm", 4, 2048, 64, 16, 32, "float32")
    assert autotune.shape_key(*args, "cuda-sm90") == jautotune.shape_key(*args, "cuda-sm90")
    assert autotune.shape_key(*args, "cuda-sm90") == \
        "lut_amm|n=4|m=2048|c=64|k=16|v=32|dtype=float32|backend=cuda-sm90"
    assert autotune.backend_of(torch.zeros(1)) == "torch-cpu"
    assert autotune.dtype_name(torch.bfloat16) == "bfloat16"


def test_no_record_follows_the_fit_rule():
    for sig, want in ((SIG, 3), (DOWN, 2)):
        version, cfg, from_record = autotune.kernel_choice(4, *sig)
        assert (version, cfg, from_record) == (want, autotune.DEFAULT, False)
        assert version == autotune.fit_version(*sig[1:])


def test_a_record_always_wins_and_reference_records_never_steer_the_card():
    cache = autotune.get_cache()
    for backend in ("tpu", "cpu"):                 # what the reference writes
        cache.put(autotune.shape_key("lut_amm", 4, *SIG, "float32", backend), _rec(1))
    assert autotune.kernel_choice(4, *SIG)[0] == 3
    assert autotune.kernel_choice(4, *SIG, backend="torch-cpu")[0] == 3
    cache.put(autotune.shape_key("lut_amm", 4, *SIG, "float32", "cuda-sm90"),
              _rec(1, block_m=64, block_c=16))
    version, cfg, from_record = autotune.kernel_choice(4, *SIG)
    assert (version, cfg.quads, cfg.block_c, from_record) == (1, 16, 16, True)
    # a record without a version (written before the version axis) means v2
    cache.put(autotune.shape_key("lut_amm", 4, *DOWN, "float32", "cuda-sm90"),
              {"block_n": 8, "block_m": 0, "block_c": 0})
    assert autotune.kernel_choice(4, *DOWN)[0] == 2


def test_cpu_dispatch_runs_the_recorded_versions_plain_version():
    x = torch.randn(5, 64)
    p, q = torch.randn(4, 16, 16), torch.randint(-127, 127, (4, 16, 24), dtype=torch.int8)
    s = torch.full((1, 1, 24), 0.02)
    for version, plain in ((1, "lut_amm_v1_plain"), (2, "lut_amm_v2_plain"),
                           (3, "fused_decode_plain")):
        autotune.get_cache().put(autotune.shape_key("lut_amm", 5, 24, 4, 16, 16, "float32",
                                                     "torch-cpu"), _rec(version))
        before = dict(ref.calls)
        ops.lut_amm(x, p, q, s)
        assert {k for k in ref.calls if ref.calls[k] != before[k]} == {plain}


def test_cache_file_roundtrip_corruption_and_shared_file(tmp_path, monkeypatch):
    path = tmp_path / "tune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    assert autotune.default_cache_path() == path
    path.write_text("{not json")
    cache = autotune.get_cache()
    assert cache.path == path and cache.load() == {}            # corrupt -> empty
    key = autotune.shape_key("lut_amm", 4, *SIG, "float32", "cuda-sm90")
    cache.put(key, _rec(2))
    cache.save()
    # the reference writes its own record to the same file meanwhile ...
    raw = json.loads(path.read_text())
    jkey = jautotune.shape_key("lut_amm", 4, *SIG, "float32", "tpu")
    raw["entries"][jkey] = _rec(1)
    path.write_text(json.dumps(raw))
    cache.put(autotune.shape_key("lut_amm", 128, *SIG, "float32", "cuda-sm90"), _rec(3))
    cache.save()                                  # ... and the port's save keeps it
    entries = json.loads(path.read_text())["entries"]
    assert {key, jkey} <= set(entries) and len(entries) == 3
    assert autotune.AutotuneCache(path).get(key)["version"] == 2
    monkeypatch.delenv("REPRO_AUTOTUNE_CACHE")
    assert autotune.default_cache_path().parts[-2:] == ("repro_torch", "autotune.json")


def test_tune_with_a_fake_timer_records_the_measured_winner():
    timed = []

    def fake(cfg, version):
        timed.append((version, cfg))
        if version == 2 and cfg.block_c == 32:
            raise ValueError("does not fit")        # a refused candidate is skipped
        return {1: 3e-5, 2: 2e-5, 3: 4e-5}[version] - cfg.block_m * 1e-9

    cfg, rec = autotune.tune("lut_amm", 4, *SIG, measure=fake, save=False)
    assert {v for v, _ in timed} == {1, 2, 3}
    assert rec["version"] == 2 and rec["measured"] and rec["source"] == "cuda_events"
    assert cfg.block_m == 4 * max(autotune.lut_mod.QUADS)
    assert autotune.kernel_choice(4, *SIG)[0] == 2
    # the fused kernel has no candidate where its codebooks do not fit
    assert autotune.candidates("lut_amm", 4, *DOWN, version=3) == []
    cands = autotune.candidates("lut_amm", 4, *DOWN, version=1)
    assert {c.block_c for c in cands} == {64, 192}      # the reference's bc, and all of C
    enc = autotune.candidates("encode", 4, 0, *SIG[1:])
    assert enc and all(c.block_m == 0 for c in enc)


def test_analytic_ranking_matches_the_fit_rule_and_never_picks_v1():
    for n in (4, 128):
        for sig in (SIG, (1024, 64, 16, 32), (6144, 64, 16, 32), DOWN):
            cfg, rec = autotune.tune("lut_amm", n, *sig, save=False)
            assert rec["version"] == autotune.fit_version(*sig[1:]) and not rec["measured"]
            # the model cannot rank launches: the wrapper's default launch is kept
            assert cfg == autotune.DEFAULT and rec["block_m"] == rec["block_c"] == 0


@pytest.mark.parametrize("c,v,block_c", [(64, 32, None), (192, 32, None), (10, 8, None),
                                         (12, 16, 5), (7, 4, 100)])
def test_v1_chunk_is_the_references(c, v, block_c):
    bc = block_c if block_c is not None else max(1, min(c, 2048 // v))
    while c % bc:
        bc -= 1
    assert ref.v1_block_c(c, v, block_c) == bc


def _bundle():
    arch = tcfg.reduce_arch(tcfg.get_arch("qwen3_1p7b"), n_layers=2, lut_use_kernel=True)
    return tcfg.build_model(arch, "lut_infer")


def test_engine_warmup_tunes_every_site_signature_once():
    tb = _bundle()
    sigs = lut_kernel_signatures(tb)
    jb = jcfg.build_model(jcfg.reduce_arch(jcfg.get_arch("qwen3_1p7b"), n_layers=2,
                                           lut_use_kernel=True), "lut_infer")
    assert len(sigs) == len({(s.d_out, s.d_in // s.lut.v) for s in jb.lut_sites()})
    params = tb.init(torch.Generator().manual_seed(0), device="cpu")
    eng = ServingEngine(tb, params, device="cpu", n_slots=2, max_seq=32, prefill_chunk=4)
    assert eng.n_lut_shapes_tuned == 2 * len(sigs) == eng.stats()["lut_shapes_tuned"]
    for m, c, k, v in sigs:
        for n in (2, 8):
            key = autotune.shape_key("lut_amm", n, m, c, k, v, "float32", "torch-cpu")
            assert autotune.get_cache().get(key)["version"] in (2, 3)
    # serving tunes the kernels its forwards run; no request calls the encode
    assert not any(key.startswith("encode|") for key in autotune.get_cache().load())
    # analytic records are kept in analytic mode: nothing left to tune
    assert warm_lut_autotune(tb, [2, 8], device="cpu") == 0
    assert ServingEngine(tb, params, device="cpu", autotune_lut=False,
                         n_slots=2, max_seq=32, prefill_chunk=4).n_lut_shapes_tuned == 0


def test_measured_warmup_needs_the_card(monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
    assert measure.measure_enabled()
    with pytest.raises(RuntimeError, match="card"):
        warm_lut_autotune(_bundle(), [2], device="cpu")
    with pytest.raises(RuntimeError, match="card"):
        measure.measure_lut_amm(4, *SIG, device="cpu")
    monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "0")
    assert not measure.measure_enabled()


def test_measured_records_are_never_retuned(monkeypatch):
    """A measured record (an earlier warm-up's, or an artifact snapshot's)
    stands even when measuring is on; analytic ones are re-tuned then."""
    tb = _bundle()
    m, c, k, v = lut_kernel_signatures(tb)[0]
    cache = autotune.get_cache()
    for sig in lut_kernel_signatures(tb):
        cache.put(autotune.shape_key("lut_amm", 2, *sig, "float32", "torch-cpu"),
                  _rec(1, measured=True))
    monkeypatch.setenv("REPRO_AUTOTUNE_MEASURE", "1")
    assert warm_lut_autotune(tb, [2], device="cpu") == 0
    cache.put(autotune.shape_key("lut_amm", 2, m, c, k, v, "float32", "torch-cpu"), _rec(2))
    with pytest.raises(RuntimeError, match="card"):      # re-tuning it would measure
        warm_lut_autotune(tb, [2], device="cpu")


@pytest.mark.parametrize("n", [4, 128])
def test_candidates_sweep_clusters_row_tiles_and_tiles(n):
    """Fused and v2 candidates name 8-row tiles at decode and 32/64-row
    staged tiles at a prefill chunk, each with every M tile its lookup
    takes, all in the cluster C fixes (block_c 0); each one fits a block
    and launches as named."""
    lut = autotune.lut_mod
    for version, (m, c, k, v) in ((3, SIG), (2, SIG), (2, DOWN)):
        cands = autotune.candidates("lut_amm", n, m, c, k, v, version)
        assert {cfg.block_c for cfg in cands} == {0}
        launches = [autotune.cluster_launch(cfg) for cfg in cands]
        assert {la["rows"] for la in launches} == ({8} if n == 4 else {32, 64})
        for rows in {la["rows"] for la in launches}:
            quads = lut.STAGED_QUADS if rows >= lut.STAGED_ROWS else lut.QUADS
            assert sorted(la["quads"] for la in launches if la["rows"] == rows) == sorted(quads)
        for la in launches:
            geo = lut.cluster_geometry(n, c, k, v, m, 112, chunked=version == 2, **la)
            assert (geo["rows"], geo["quads"], geo["cluster"]) == (la["rows"], la["quads"], 16)


def test_a_record_written_before_the_cluster_launch_still_launches():
    """Records of the one-block kernels (block_n 8; block_c = C for the
    fused kernel, v2's staging chunk) keep their version and take the
    default cluster launch, which fits."""
    cache = autotune.get_cache()
    old = {"fused": (SIG, _rec(3, measured=True, block_m=16, block_c=64)),
           "v2": (DOWN, _rec(2, measured=True, block_m=16, block_c=64))}
    for n in (4, 128):
        for (m, c, k, v), rec in old.values():
            cache.put(autotune.shape_key("lut_amm", n, m, c, k, v, "float32", "cuda-sm90"), rec)
            version, cfg, from_record = autotune.kernel_choice(n, m, c, k, v)
            assert from_record and version == rec["version"] and cfg.block_n == 8
            launch = autotune.cluster_launch(cfg)
            assert launch == {"rows": None, "quads": None}
            geo = autotune.lut_mod.cluster_geometry(n, c, k, v, m, 112, chunked=version == 2,
                                                    **launch)
            default = autotune.lut_mod.cluster_geometry(n, c, k, v, m, 112,
                                                        chunked=version == 2)
            assert geo == default and geo["cluster"] == 16


@pytest.mark.parametrize("n", [4, 128])
def test_v1_and_encode_records_of_the_one_block_kernels_still_launch(tmp_path, n):
    """v1 and encode records as an artifact snapshot of the one-block kernels
    holds them (v1: 8-row tiles, an M tile of 4Q columns, the reference's
    chunk of the sum or all of C; encode: a row range, or 0, and a staging
    chunk of up to 64 codebooks) resolve to launches that fit: v1 keeps its
    8 rows, M tile and chunk of the sum; an encode block too large for
    shared memory now takes the default launch."""
    entries = {}
    for m, c, k, v in (SIG, DOWN):
        for q in autotune.lut_mod.QUADS:
            for bc in sorted({ref.v1_block_c(c, v), c}):
                entries[f"{q}-{bc}-{c}"] = (
                    autotune.shape_key("lut_amm", n, m, c, k, v, "float32", "cuda-sm90"),
                    {"block_n": 8, "block_m": 4 * q, "block_c": bc, "version": 1,
                     "predicted_us": 70.0, "measured": True, "source": "cuda_events"})
        for rows in (0, -(-n // 4)):
            for chunk in (64, 32, 16):
                entries[f"enc-{rows}-{chunk}-{c}"] = (
                    autotune.shape_key("encode", n, 0, c, k, v, "float32", "cuda-sm90"),
                    {"block_n": rows, "block_m": 0, "block_c": chunk, "predicted_us": 25.0,
                     "measured": True, "source": "cuda_events"})
    for key, rec in entries.values():
        # one record per key at a time, read back from a snapshot file
        path = tmp_path / "autotune.json"
        path.write_text(json.dumps({"version": 1, "entries": {key: rec}}))
        cache = autotune.AutotuneCache(path)
        kind, _, m, c, k, v = (f.split("=")[-1] for f in key.split("|")[:6])
        m, c, k, v = int(m), int(c), int(k), int(v)
        if kind == "lut_amm":
            version, cfg, from_record = autotune.kernel_choice(n, m, c, k, v, cache=cache)
            assert version == 1 and from_record
            launch = autotune.v1_launch(cfg)
            assert launch == {"rows": 8, "quads": rec["block_m"] // 4, "block_c": rec["block_c"]}
            geo = autotune.lut_mod.v1_geometry(n, c, k, v, m, 112, **launch)
            assert (geo["rows"], geo["quads"], geo["block_c"]) == (8, rec["block_m"] // 4,
                                                                   rec["block_c"])
        else:
            cfg = autotune.lookup("encode", n, 0, c, k, v, cache=cache)
            launch = autotune.encode_launch(cfg, n, c, k, v)
            geo = autotune.enc_mod.encode_geometry(n, c, k, v, autotune.N_SMS, **launch)
            fits = autotune.enc_mod.smem_bytes(rec["block_n"] or geo["rows"], rec["block_c"],
                                               k, v) <= autotune.lut_mod.MAX_SMEM
            if fits and rec["block_n"]:
                assert (geo["rows"], geo["chunk_c"]) == (rec["block_n"], rec["block_c"])
            if not fits:
                assert launch == {"block_n": None, "block_c": None}
    # an M tile the cluster kernel does not offer takes the default
    assert autotune.v1_launch(autotune.BlockConfig(8, 12, 64))["quads"] is None


@pytest.mark.parametrize("shape", [(4, *SIG), (128, *SIG), (4, *DOWN), (128, *DOWN)]
                         + [(n, m, d // v, k, v) for n, d, m, k, v in RAGGED],
                         ids=lambda s: str(s))
def test_analytic_model_never_picks_v1(shape):
    """v1 runs v2's cluster chain and then each element's ordered fp32 chain:
    the model prices it above v2 at every launch, so without a timer the
    tuner never records it."""
    n, m, c, k, v = shape
    for cfg in [autotune.DEFAULT] + autotune.candidates("lut_amm", n, m, c, k, v, 1):
        same = autotune.BlockConfig(cfg.block_n, cfg.block_m, 0)     # v2 at v1's launch
        assert (autotune.predict_us("lut_amm", n, m, c, k, v, cfg, version=1)
                > autotune.predict_us("lut_amm", n, m, c, k, v, same, version=2))
    _, rec = autotune.tune("lut_amm", n, m, c, k, v, save=False)
    assert rec["version"] == autotune.fit_version(c, k, v) != 1
