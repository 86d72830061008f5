"""The port's `ShardingRules` against the reference's: for every param leaf
of all 11 archs (DENSE, LUT_TRAIN and LUT_INFER trees at full published
width, shapes only) and every dense and paged cache leaf, at tp 2 and 4,
`param_spec` (with and without the site roles) and `cache_spec` equal the
reference's `PartitionSpec` entries, and `site_roles` equals the
reference's. The reference's rules need a mesh of tp devices, so its side
runs in a subprocess with forced host devices. Also: every dense-block arch
the slice serves, placed by these rules at tp 2 (an untied head gathered,
non-gated MLPs, a non-causal model), serves the launcher's
tokens unsharded."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.checkpoint.paths import flatten_tree
from repro_torch.configs import ARCH_IDS, EXTRA_IDS, build_model, get_arch
from repro_torch.core.amm import Mode
from repro_torch.distributed.sharding import ShardingRules, site_roles
from repro_torch.models.attention import PagedSpec
from tests._subproc import SRC, run_with_devices

ARCHS = ARCH_IDS + EXTRA_IDS
MODES = ("dense", "lut_train", "lut_infer")
TPS = (2, 4)
CACHE_B, CACHE_S = 4, 64


def _jsonable(spec) -> list:
    return [list(e) if isinstance(e, tuple) else e for e in spec]


@pytest.fixture(scope="module")
def reference_specs() -> dict:
    """{tp: {arch: {mode: {"params", "params_roles", "roles", "caches"}}}}
    from the reference's rules on a (1, tp) host mesh."""
    out = run_with_devices(textwrap.dedent(f"""
        import json
        import jax
        from repro.checkpoint.checkpointer import tree_paths
        from repro.configs import build_model, get_arch
        from repro.core.amm import Mode
        from repro.distributed.sharding import ShardingRules, site_roles
        from repro.launch.mesh import make_host_mesh
        from repro.models.attention import PagedSpec

        def js(spec):
            return [list(e) if isinstance(e, tuple) else e for e in spec]

        res = {{}}
        for tp in {TPS!r}:
            rules = ShardingRules(make_host_mesh(data=1, model=tp))
            per = res[tp] = {{}}
            for name in {ARCHS!r}:
                for mode in {MODES!r}:
                    b = build_model(get_arch(name), Mode(mode))
                    specs = jax.eval_shape(b.init, jax.random.PRNGKey(0))
                    leaves = dict(zip(tree_paths(specs), jax.tree_util.tree_leaves(specs)))
                    roles = site_roles(b)
                    caches = {{}}
                    for paged in (None, PagedSpec(n_pages=9, page_size=16)):
                        c = b.init_caches({CACHE_B}, {CACHE_S}, abstract=True, paged=paged)
                        for p, l in zip(tree_paths(c), jax.tree_util.tree_leaves(c)):
                            caches[("paged:" if paged else "dense:") + p] = [
                                list(l.shape), js(rules.cache_spec(p, l.shape, {CACHE_B}))]
                    per.setdefault(name, {{}})[mode] = {{
                        "params": {{p: [list(l.shape), js(rules.param_spec(p, l.shape))]
                                   for p, l in leaves.items()}},
                        "params_roles": {{p: js(rules.param_spec(p, l.shape, site_roles=roles))
                                         for p, l in leaves.items()}},
                        "roles": roles,
                        "caches": caches,
                    }}
        print("SPECS=" + json.dumps(res))
        """), n_devices=max(TPS))
    line = next(ln for ln in out.splitlines() if ln.startswith("SPECS="))
    return {int(tp): v for tp, v in json.loads(line[len("SPECS="):]).items()}


def _cache_leaves(bundle) -> dict:
    out = {}
    for paged in (None, PagedSpec(n_pages=9, page_size=16)):
        tree = bundle.cache_specs(CACHE_B, CACHE_S, paged=paged)
        for p, spec in flatten_tree(tree).items():
            out[("paged:" if paged else "dense:") + p] = tuple(spec.shape)
    return out


@pytest.mark.parametrize("tp", TPS)
@pytest.mark.parametrize("name", ARCHS)
def test_specs_match_the_reference(reference_specs, name, tp):
    rules = ShardingRules(model=tp)
    n_sharded = 0
    for mode in MODES:
        want = reference_specs[tp][name][mode]
        bundle = build_model(get_arch(name), Mode(mode))
        roles = site_roles(bundle)
        assert roles == want["roles"], (mode, name)
        leaves = {p: tuple(s.shape) for p, s in flatten_tree(bundle.param_specs()).items()}
        assert sorted(leaves) == sorted(want["params"]), (mode, name)
        for path, shape in leaves.items():
            ref_shape, ref_spec = want["params"][path]
            assert list(shape) == ref_shape, (mode, path)
            got = _jsonable(rules.param_spec(path, shape))
            assert got == ref_spec, (mode, path, got, ref_spec)
            got_roles = _jsonable(rules.param_spec(path, shape, site_roles=roles))
            assert got_roles == want["params_roles"][path], (mode, path)
            n_sharded += "model" in got_roles
        caches = _cache_leaves(bundle)
        assert sorted(caches) == sorted(want["caches"]), (mode, name)
        for path, shape in caches.items():
            ref_shape, ref_spec = want["caches"][path]
            assert list(shape) == ref_shape, (mode, path)
            assert _jsonable(rules.cache_spec(path.split(":", 1)[1], shape, CACHE_B)) \
                == ref_spec, (mode, path)
    assert n_sharded > 0, name


def test_rules_are_pure_and_fall_back_to_replication():
    rules = ShardingRules(model=3)
    # 2048 does not divide by 3: a column site falls back to replication
    assert rules.param_spec("segments/1/attn/q/table_q", (27, 64, 16, 2048)) == (None,) * 4
    assert rules.param_spec("segments/1/attn/o/table_q", (27, 63, 16, 2048)) \
        == (None, "model", None, None)
    assert rules.batch_dim(4) == "data" and ShardingRules(model=2, data=3).batch_dim(4) is None
    assert ShardingRules.for_mesh(type("M", (), {"shape": {"data": 1, "model": 2}})()).tp == 2


def test_each_served_dense_arch_gives_the_unsharded_tokens_at_tp2():
    """The launcher's random-init burst, reduced, at tp 1 and 2 (gloo on the
    CPU): llama3_8b (untied head), minitron_8b (relu2, not gated),
    command_r_35b, bert_base (gelu, not gated, bidirectional)."""
    archs = ("llama3_8b", "minitron_8b", "command_r_35b", "bert_base")
    procs = {(a, tp): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu", "--arch", a,
         "--tp", str(tp), "--use-kernel", "--layers", "2", "--d-model", "64", "--vocab", "128",
         "--requests", "2", "--slots", "2", "--max-tokens", "6"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
        for a in archs for tp in (1, 2)}
    outs = {k: p.communicate(timeout=300) for k, p in procs.items()}
    for (a, tp), p in procs.items():
        assert p.returncode == 0, (a, tp, outs[(a, tp)][1])
    for a in archs:
        reqs = [[ln for ln in outs[(a, tp)][0].splitlines() if ln.strip().startswith("req ")]
                for tp in (1, 2)]
        assert len(reqs[0]) == 2 and reqs[0] == reqs[1], a
