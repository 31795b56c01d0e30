"""The port's sharded serving held against the JAX package: the rule tables
and logical specs (``repro_torch.distributed``), the mesh builder
(``launch.mesh``), and the mesh paths of ``lm``, ``checkpoint``,
``serve.generate`` and ``Engine``.

Single-process tests read only a mesh's axis names and sizes: the port's
tables take a ``sharding.MeshShape``, the reference's a ``jax.sharding.Mesh``
of one host device repeated, as its own rule tests build it.

The multi-rank scenarios run in ONE spawned world of 4 gloo ranks on a
(data=2, model=2) mesh, shared by the module (``world``).  The ranks import
no JAX (this module imports it lazily, in the parent's fixtures), run with
one torch thread each, meet through a ``file://`` rendezvous under the test's
temporary directory (no port, so xdist workers never collide), and each
writes its results to a file the parent reads; the parent builds its
references (the port's unsharded engines, the JAX package's engines on the
port's weights) while the ranks run.  The models are smoke configs, in
their default bfloat16, where a row of a CPU product does not depend on
how many rows it is multiplied with, so a rank's block of slots computes
the bits the whole pool does; and in float32, where the port's engine is
held token-exact to the JAX package's (``tests/test_torch_engine.py``;
torch and XLA round bfloat16 products apart, so greedy bf16 tokens of the
two packages can part after a few steps).

Tolerances: exact-mode bf16 tokens bit-identical to the port's unsharded
engine (dense, ring, int8); exact-mode float32 tokens equal to the JAX
package's engine's (dense and ring); every rank's host results identical.  Tensor parallel (the default ``serve_rules``): the
'model' axis's partial sums reassociate, so the contract is integrity
(every request completes with its budget, tokens in the vocabulary) and
float32 first-step logits within 1e-5 absolute of the unsharded ones
(largest |logit| about 3.4).
"""
import os
import pickle
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.distributed import sharding
from repro_torch.distributed.constraints import logical_to_spec
from repro_torch.distributed.sharding import (MeshShape, divisible_spec, is_spec_leaf,
                                              serve_pool_shardings, serve_rules, train_rules)
from repro_torch.launch import serve
from repro_torch.launch.engine import Engine, Request, SpecConfig
from repro_torch.models import convert, lm
from repro_torch.optim import opt_state_specs

LM_IDS = tuple(a for a in ARCH_IDS if a != "e2afs-fp16")
WORLD = 4
CACHE = 24

# one arch per cache family the slot pool supports
CACHE_FAMILIES = [
    ("qwen3-4b", False),          # dense GQA float
    ("qwen3-4b", True),           # dense GQA int8 (+ scale planes)
    ("gemma3-1b", False),         # sliding-window ring (window + global mix)
    ("mamba2-2.7b", False),       # SSD recurrent state
    ("recurrentgemma-2b", False),  # RG-LRU state + ring window
]

# (names, shape) of the meshes the tables are held on
MESHES = [
    (("data", "model"), (16, 16)),
    (("pod", "data", "model"), (2, 16, 16)),
    (("data", "kv", "qg"), (16, 8, 2)),
    (("data", "model"), (2, 2)),
    (("data", "model"), (1, 1)),
]


def _mesh(shape=(2, 2), axes=("data", "model")):
    return MeshShape(axes, shape)


def _jax_mesh(shape, axes):
    import jax
    from jax.sharding import Mesh

    dev = np.asarray([jax.devices()[0]] * int(np.prod(shape))).reshape(shape)
    return Mesh(dev, axes)


def _flat(tree, path=()):
    """{path: spec} of a spec tree (dicts, lists, spec tuples)."""
    if is_spec_leaf(tree):
        return {"/".join(path): tree}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat(tree[key], path + (str(key),)).items()}
    return {k: v for i, node in enumerate(tree) for k, v in _flat(node, path + (str(i),)).items()}


# ---------------------------------------------------------------------------
# Rule tables and specs (the reference's tests/distributed, mirrored)
# ---------------------------------------------------------------------------


class TestLogicalToSpec:
    RULES = {"embed": ("pod", "data"), "heads": "model", "mlp": "model", "batch": ("data",)}

    def test_basic_mapping(self):
        assert logical_to_spec(("embed", "heads", None), self.RULES) == (
            ("pod", "data"), "model", None)

    def test_axis_claimed_once(self):
        # second claimant of 'model' degrades to replication
        assert logical_to_spec(("heads", "mlp"), self.RULES) == ("model", None)

    def test_unknown_axis_replicates(self):
        assert logical_to_spec(("nope", None), self.RULES) == (None, None)


class TestDivisibleSpec:
    def test_indivisible_dim_replicates(self):
        assert divisible_spec(("model", None), (10, 3), _mesh((4, 8))) == (None, None)

    def test_divisible_dim_kept(self):
        assert divisible_spec(("model", None), (16, 3), _mesh((4, 8))) == ("model", None)

    def test_tuple_axes_partial_keep(self):
        # 8 divides by data(4) but then not by model(8): keep only data
        assert divisible_spec((("data", "model"), None), (8, 3), _mesh((4, 8))) == ("data", None)


class TestRuleTables:
    def test_train_rules_fsdp_tp(self):
        r = train_rules(get_config("qwen3-4b"), _mesh((16, 16)))
        assert r["embed"] == ("data",) and r["heads"] == "model"
        assert r["batch"] == ("data",)

    def test_train_rules_moe_ep(self):
        r = train_rules(get_config("qwen3-moe-235b-a22b"), _mesh((16, 16)))
        assert r["expert"] == "model"  # 128 % 16 == 0
        r2 = train_rules(get_config("mixtral-8x22b"), _mesh((16, 16)))
        assert r2["expert"] is None  # 8 % 16 != 0 -> replicate experts

    def test_serve_rules_never_shard_kv_seq(self):
        for arch in ("qwen3-4b", "deepseek-67b", "gemma3-1b"):
            assert serve_rules(get_config(arch), _mesh((16, 16)))["kv_seq"] is None

    def test_serve_rules_kv_mesh(self):
        r = serve_rules(get_config("deepseek-67b"), _mesh((16, 8, 2), ("data", "kv", "qg")))
        assert r["kv_heads"] == "kv"
        assert r["heads"] == ("kv", "qg")

    def test_seq_parallel_toggles_seq(self):
        cfg = get_config("qwen3-4b")
        assert train_rules(cfg, _mesh((16, 16)))["seq"] is None
        assert train_rules(cfg, _mesh((16, 16)), seq_parallel=True)["seq"] == "model"


@pytest.mark.parametrize("arch", LM_IDS)
def test_rule_tables_equal_the_references(arch):
    """train_rules (with and without seq_parallel) and serve_rules (TP,
    exact, seq_shard_kv) equal the reference's for the full config on every
    mesh shape, and the parameter-size estimate behind the MoE policy."""
    from repro.configs import get_config as jax_config
    from repro.distributed import sharding as jsh

    cfg, jcfg = get_config(arch), jax_config(arch)
    assert sharding._param_gib(cfg) == jsh._param_gib(jcfg)
    for names, shape in MESHES:
        mesh, jmesh = _mesh(shape, names), _jax_mesh(shape, names)
        if "model" in names:
            for sp in (False, True):
                assert train_rules(cfg, mesh, seq_parallel=sp) == jsh.train_rules(
                    jcfg, jmesh, seq_parallel=sp), (names, shape, sp)
        for kw in ({}, {"replicate_params": True}, {"seq_shard_kv": True}):
            assert serve_rules(cfg, mesh, **kw) == jsh.serve_rules(jcfg, jmesh, **kw), (
                names, shape, kw)


@pytest.mark.parametrize("arch", LM_IDS)
def test_param_specs_equal_the_references(arch):
    """The parameters' logical specs (the second value of the reference's
    ``lm.init``) leaf by leaf, under the reference's tree; every port
    parameter has one."""
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jax_lm

    cfg = get_smoke_config(arch)
    _, jspecs = jax_lm.init(jax_smoke(arch), jax.random.key(0), abstract=True)
    assert _flat(lm.param_specs(cfg)) == _flat(jspecs)
    named = lm.named_param_specs(cfg)
    model = lm.LM(cfg, device=torch.device("meta"))
    assert set(named) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        assert len(named[name]) == p.ndim, name


@pytest.mark.parametrize("arch,quantized", CACHE_FAMILIES)
def test_cache_specs_equal_the_references(arch, quantized):
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jax_lm

    cfg = get_smoke_config(arch)
    _, jspecs = jax_lm.init_cache(jax_smoke(arch), 4, 16, quantized=quantized, abstract=True)
    assert _flat(lm.cache_specs(cfg, quantized=quantized)) == _flat(jspecs)
    cache = lm.init_cache(cfg, 4, 16, quantized=quantized, abstract=True)
    specs = _flat(lm.cache_specs(cfg, quantized=quantized))
    for path, t in _flat_tensors(cache).items():
        assert len(specs[path]) == t.ndim and t.device.type == "meta", path


def _flat_tensors(tree, path=()):
    if isinstance(tree, torch.Tensor):
        return {"/".join(path): tree}
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in _flat_tensors(tree[key],
                                                                path + (str(key),)).items()}
    return {k: v for i, node in enumerate(tree)
            for k, v in _flat_tensors(node, path + (str(i),)).items()}


def test_cross_kv_and_optimizer_specs_equal_the_references():
    import jax
    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jax_lm
    from repro.optim import opt_state_specs as jax_opt_specs

    assert _flat(lm.cross_kv_specs()) == _flat(jax_lm.cross_kv_specs())
    for arch in ("qwen3-4b", "gemma3-1b", "whisper-small"):
        _, jspecs = jax_lm.init(jax_smoke(arch), jax.random.key(0), abstract=True)
        ours, ref = opt_state_specs(lm.param_specs(get_smoke_config(arch))), jax_opt_specs(jspecs)
        assert ours["step"] == ref["step"] == ()
        for key in ("m", "v"):
            assert _flat(ours[key]) == _flat(ref[key]), (arch, key)


@pytest.mark.parametrize("arch,quantized", CACHE_FAMILIES)
@pytest.mark.parametrize("replicate_params", [False, True])
def test_each_physical_axis_claimed_at_most_once(arch, quantized, replicate_params):
    cfg = get_smoke_config(arch, sqrt_unit="e2afs")
    rules = serve_rules(cfg, _mesh(), replicate_params=replicate_params)
    for leaf in _flat(lm.cache_specs(cfg, quantized=quantized)).values():
        spec = logical_to_spec(leaf, rules)
        phys = [a for part in spec if part is not None
                for a in ((part,) if isinstance(part, str) else part)]
        assert len(phys) == len(set(phys)), (leaf, spec)


@pytest.mark.parametrize("arch,quantized", CACHE_FAMILIES)
def test_slot_axis_shards_over_data_and_time_never_shards(arch, quantized):
    cfg = get_smoke_config(arch, sqrt_unit="e2afs")
    rules = serve_rules(cfg, _mesh())
    assert rules["kv_seq"] is None  # ring writes stay O(token), not O(cache)
    for leaf in _flat(lm.cache_specs(cfg, quantized=quantized)).values():
        for ax_name, part in zip(leaf, logical_to_spec(leaf, rules)):
            if ax_name == "batch":
                assert part == "data", leaf
            if ax_name == "kv_seq":
                assert part is None, leaf


@pytest.mark.parametrize("quantized", [False, True])
def test_serve_pool_shardings_cover_pool_state(quantized):
    """The engine-facing bundle: the cache tree matches init_cache's, the
    slot axis shards over 'data' (Shard(0) or, stacked, Shard(1) on the
    data mesh dim), the cache's time axis never shards, the scheduler
    vectors ride the batch sharding and host operands replicate."""
    from torch.distributed.tensor import Replicate, Shard

    cfg = get_smoke_config("qwen3-4b", sqrt_unit="e2afs")
    mesh = _mesh()
    sh = serve_pool_shardings(cfg, mesh, serve_rules(cfg, mesh), num_slots=4, cache_len=16,
                              quantized=quantized)
    cache = lm.init_cache(cfg, 4, 16, quantized=quantized, abstract=True)
    assert set(sh["cache"]) == set(cache)
    for name, leaf in sh["cache"].items():
        assert leaf.spec[1] == "data" and leaf.spec[2] is None, name
        assert leaf.placements[0] == Shard(1), name
    assert sh["vec"].spec == ("data",) and sh["vec"].placements == (Shard(0), Replicate())
    assert sh["tok"].spec == ("data", None)
    assert sh["keys"].spec == ("data", None)
    assert sh["replicated"].spec == () and sh["replicated"].placements == (Replicate(),) * 2


def test_indivisible_slots_replicate_and_axis_order_is_asserted():
    """``num_slots`` the mesh cannot divide leaves the slot axis replicated
    (every rank computes every slot, as in the reference); several mesh
    axes on one dim must come in mesh order."""
    cfg = get_smoke_config("qwen3-4b", sqrt_unit="e2afs")
    mesh = _mesh()
    rules = serve_rules(cfg, mesh, replicate_params=True)
    assert serve_pool_shardings(cfg, mesh, rules, num_slots=3, cache_len=8)["vec"].spec == (None,)
    assert serve_pool_shardings(cfg, mesh, rules, num_slots=2, cache_len=8)["vec"].spec == (
        "data",)
    assert serve_pool_shardings(cfg, mesh, rules, num_slots=4, cache_len=8)["vec"].spec == (
        ("data", "model"),)
    with pytest.raises(ValueError, match="mesh order"):
        sharding.placements_for((("model", "data"),), mesh)


def test_refusals_before_any_device_work():
    """serve's mesh path is scan-only, a mesh needs a process group of its
    size, and a speculative engine refuses a mesh (the reference's
    messages)."""
    with pytest.raises(ValueError, match="only wired into mode='scan'"):
        serve.generate("qwen3-4b", mode="loop", mesh=object(), verbose=False, device="cpu")
    if not torch.distributed.is_initialized():
        from repro_torch.launch.mesh import make_production_mesh

        with pytest.raises(RuntimeError, match="world size 4"):
            make_production_mesh(shape=(2, 2), device="cpu")
    cfg = get_smoke_config("qwen3-4b")
    with pytest.raises(ValueError, match="does not run on a mesh"):
        Engine(None, cfg, spec=SpecConfig(k=2), mesh=_mesh())


# ---------------------------------------------------------------------------
# The spawned world: 4 gloo ranks on a (2, 2) mesh
# ---------------------------------------------------------------------------


def _requests(vocab, n, *, seed=0, prompts=(3, 5), gens=(2, 4, 7), stagger=True):
    rng = np.random.RandomState(seed)
    return [Request(uid=i, prompt=rng.randint(0, vocab, size=int(rng.choice(prompts))).astype(
                        np.int32),
                    max_new_tokens=int(rng.choice(gens)),
                    arrival_s=float(i) * 1e-3 if stagger else 0.0)
            for i in range(n)]


def _model(arch, **kw):
    cfg = get_smoke_config(arch, sqrt_unit="e2afs", **kw)
    return cfg, lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")


# (arch, slots, requests, quantized): 4 slots, one a rank; 2 slots, over
# 'data' and replicated over 'model'; 3 slots, indivisible, replicated
EXACT = (("qwen3-4b", 4, 7, False), ("gemma3-1b", 2, 7, False), ("qwen3-4b", 3, 5, True))
# (arch, slots): float32, against the JAX package's engine
EXACT_F32 = (("qwen3-4b", 4), ("gemma3-1b", 2))
TP_PROMPT = (4, 6)


def _tokens(done) -> dict:
    return {uid: np.asarray(c.tokens) for uid, c in done.items()}


def _finished(path) -> list:
    """(uid, tokens) of every ``finished`` record of a journal."""
    from repro_torch.launch.journal import read_journal

    return [(r["uid"], np.asarray(r["tokens"], np.int32))
            for r in read_journal(path) if r["kind"] == "finished"]


def _rank_scenarios(rank: int, tmp: str) -> dict:
    """Every multi-rank scenario, in one order on every rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh(shape=(2, 2), device="cpu")
    out = {"coordinate": tuple(mesh.get_coordinate())}
    kw = dict(cache_len=CACHE, chunk=3)

    for arch, slots, n, quantized in EXACT:
        cfg, model = _model(arch)
        eng = Engine(model, cfg, num_slots=slots, quantized_kv=quantized, mesh=mesh,
                     rules=serve_rules(cfg, mesh, replicate_params=True), **kw)
        eng.warmup(prompt_lens={3, 5})
        out[f"exact/{arch}/{slots}"] = _tokens(eng.run(_requests(cfg.vocab, n)))
        if slots == 4:  # the pool keeps its placements and its blocks through a serve
            want = sharding.serve_pool_tree(eng._pool_sh)
            same = [dt.placements == sh.placements and dt.to_local().data_ptr() == t.data_ptr()
                    for dt, sh, t in zip(lm.pool_tensors(eng._dpool), lm.pool_tensors(want),
                                         lm.pool_tensors(eng.pool))]
            out["placements_kept"] = all(same) and len(same) == len(lm.pool_tensors(eng.pool))
            out["rows"] = (eng._row0, eng.pool["tok"].shape[0])
    for arch, slots in EXACT_F32:
        cfg, model = _model(arch, act_dtype="float32")
        eng = Engine(model, cfg, num_slots=slots, mesh=mesh,
                     rules=serve_rules(cfg, mesh, replicate_params=True), **kw)
        out[f"f32/{arch}"] = _tokens(eng.run(_requests(cfg.vocab, 7)))

    # tensor parallel: the engine's integrity, and float32 first-step logits
    cfg, model = _model("qwen3-4b")
    eng = Engine(model, cfg, num_slots=4, mesh=mesh, rules=serve_rules(cfg, mesh), **kw)
    eng.warmup(prompt_lens={3, 5})
    out["tp/tokens"] = _tokens(eng.run(_requests(cfg.vocab, 6)))
    out["tp/local_kv"] = tuple(eng.pool["cache"]["k"].shape)
    cfg32, model32 = _model("qwen3-4b", act_dtype="float32")
    rules = serve_rules(cfg32, mesh)
    local = sharding.place_model(model32, cfg32, mesh, rules)
    prompt = torch.randint(0, cfg32.vocab, TP_PROMPT, generator=torch.Generator().manual_seed(1))
    like = lm.init_cache(cfg32, TP_PROMPT[0], 16, abstract=True)
    cache = sharding.local_tree(sharding.zeros_tree(like, sharding.shardings_for(
        lm.cache_specs(cfg32), mesh, rules, like)))
    rows = sharding.shardings_for(("batch", None), mesh, rules, prompt)
    logits, _ = lm.prefill(local, cfg32, cache, sharding.place(prompt, rows).to_local(),
                           mesh=mesh, rules=rules)
    out["tp/logits"] = sharding.gather(logits, rows).numpy()

    # serve.generate on the mesh, exact rules
    gcfg = get_smoke_config("qwen3-4b", sqrt_unit="e2afs")
    out["generate"] = serve.generate(
        "qwen3-4b", batch=4, prompt_len=5, gen_len=6, reps=1, verbose=False, device="cpu",
        mesh=mesh, rules=serve_rules(gcfg, mesh, replicate_params=True))[0].numpy()

    # the options that refuse a mesh
    from repro_torch.core.faults import FaultConfig
    from repro_torch.launch.engine import AccuracySLO

    refusals = {}
    for name, extra in (("spec", dict(spec=SpecConfig(k=2))),
                        ("faults", dict(faults=FaultConfig(site="sqrt_man", rate=1.0))),
                        ("slo", dict(slo=AccuracySLO()))):
        try:
            Engine(model, cfg, num_slots=4, mesh=mesh, **extra, **kw)
            refusals[name] = None
        except (ValueError, NotImplementedError) as e:
            refusals[name] = f"{type(e).__name__}: {e}"
    out["refusals"] = refusals

    # elastic resume: a one-device snapshot onto the mesh ...
    exact = serve_rules(cfg, mesh, replicate_params=True)
    reqs = _requests(cfg.vocab, 4, stagger=False)
    snap, jpath = os.path.join(tmp, "snap-one"), os.path.join(tmp, "journal-one.jsonl")
    if rank == 0:
        Engine(model, cfg, num_slots=4, snapshot_dir=snap, snapshot_every_chunks=1,
               journal=jpath, **kw).run(reqs, max_chunks=2)
    dist.barrier()
    eng = Engine.resume(model, cfg, snap, journal=jpath, chunk=3, mesh=mesh, rules=exact)
    out["resumed_on_mesh"] = sorted(eng.run([]))
    if rank == 0:
        out["onto_mesh"] = _finished(jpath)
    # ... and a mesh snapshot onto one device
    snap, jpath = os.path.join(tmp, "snap-mesh"), os.path.join(tmp, "journal-mesh.jsonl")
    Engine(model, cfg, num_slots=4, snapshot_dir=snap, snapshot_every_chunks=1, journal=jpath,
           mesh=mesh, rules=exact, **kw).run(reqs, max_chunks=2)
    if rank == 0:
        Engine.resume(model, cfg, snap, journal=jpath, chunk=3).run([])
        out["off_mesh"] = _finished(jpath)
    dist.barrier()
    return out


def _rank_main(rank: int, init_file: str, tmp: str) -> None:
    """One rank of the world: one torch thread, gloo through a file
    rendezvous, its results pickled to ``rank<r>.pkl``."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        out = _rank_scenarios(rank, tmp)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _references() -> dict:
    """The parent's side: the port's unsharded engines, the JAX package's
    engines on the port's weights, unsharded float32 logits and
    ``generate``."""
    import jax

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch.engine import Engine as JaxEngine
    from repro.launch.engine import Request as JaxRequest

    ref = {}
    kw = dict(cache_len=CACHE, chunk=3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # these smoke shapes run fastest on one thread
    try:
        ref.update(_port_references())
    finally:
        torch.set_num_threads(threads)
    for arch, _ in EXACT_F32:
        cfg, model = _model(arch, act_dtype="float32")
        params = jax.tree.map(jax.numpy.asarray, convert.params_to_numpy(model))
        jreqs = [JaxRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                            arrival_s=r.arrival_s) for r in _requests(cfg.vocab, 7)]
        jeng = JaxEngine(params, jax_smoke(arch, sqrt_unit="e2afs", act_dtype="float32"),
                         num_slots=2, **kw)
        ref[f"jax/{arch}"] = _tokens(jeng.run(jreqs))
    return ref


def _port_references() -> dict:
    ref = {}
    kw = dict(cache_len=CACHE, chunk=3)
    for arch, slots, n, quantized in EXACT:
        cfg, model = _model(arch)
        reqs = _requests(cfg.vocab, n)
        ref[f"exact/{arch}/{slots}"] = _tokens(
            Engine(model, cfg, num_slots=slots, quantized_kv=quantized, **kw).run(reqs))
    cfg, model = _model("qwen3-4b")
    ref["uninterrupted"] = _tokens(Engine(model, cfg, num_slots=4, **kw).run(
        _requests(cfg.vocab, 4, stagger=False)))
    cfg32, model32 = _model("qwen3-4b", act_dtype="float32")
    prompt = torch.randint(0, cfg32.vocab, TP_PROMPT, generator=torch.Generator().manual_seed(1))
    logits, _ = lm.prefill(model32, cfg32, lm.init_cache(cfg32, TP_PROMPT[0], 16, device="cpu"),
                           prompt)
    ref["tp/logits"] = logits.numpy()
    ref["generate"] = serve.generate("qwen3-4b", batch=4, prompt_len=5, gen_len=6, reps=1,
                                     verbose=False, device="cpu")[0].numpy()
    return ref


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 4-rank world's results (one dict a rank) beside the parent's
    references, computed while the ranks run."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh_world")
    t0 = time.perf_counter()
    ctx = mp.start_processes(_rank_main, args=(str(tmp / "rendezvous"), str(tmp)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        ref = _references()
        while not ctx.join(timeout=5):
            if time.perf_counter() - t0 > 240:
                raise TimeoutError("the 4-rank world did not finish in 240 s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, ref


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_world_coordinates_are_data_major(world):
    ranks, _ = world
    assert [r["coordinate"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("arch,slots,n,quantized", EXACT)
def test_exact_mode_bit_identical_to_unsharded(world, arch, slots, n, quantized):
    """Exact mode (params replicated, slots over the whole mesh): dense
    (a slot a rank), ring (slots over 'data', replicated over 'model') and
    int8 (3 slots, replicated on every rank) serve the unsharded engine's
    tokens, bit for bit, on every rank."""
    ranks, ref = world
    key = f"exact/{arch}/{slots}"
    assert len(ref[key]) == n
    for r in ranks:
        assert _equal(r[key], ref[key]), (key, r["coordinate"])


@pytest.mark.parametrize("arch,slots", EXACT_F32)
def test_exact_mode_token_exact_against_the_jax_engine(world, arch, slots):
    """Float32 exact mode on the mesh serves the JAX package's engine's
    tokens (dense and ring caches), on every rank."""
    ranks, ref = world
    assert len(ref[f"jax/{arch}"]) == 7
    for r in ranks:
        assert _equal(r[f"f32/{arch}"], ref[f"jax/{arch}"]), (arch, r["coordinate"])


def test_exact_mode_pool_keeps_its_placements(world):
    """After a serve every pool DTensor still has the placements
    ``serve_pool_shardings`` gives, and its local block is the tensor the
    steps updated in place; with 4 slots each rank holds one, in
    data-major order."""
    ranks, _ = world
    assert all(r["placements_kept"] for r in ranks)
    assert [r["rows"] for r in ranks] == [(0, 1), (1, 1), (2, 1), (3, 1)]


def test_tp_mode_integrity_and_logits(world):
    """Tensor parallel: every request completes with its whole budget,
    tokens in the vocabulary, all ranks alike; a rank holds half the KV
    heads; float32 first-step logits within 1e-5 of the unsharded."""
    ranks, ref = world
    cfg = get_smoke_config("qwen3-4b")
    reqs = {r.uid: r for r in _requests(cfg.vocab, 6)}
    toks = ranks[0]["tp/tokens"]
    assert set(toks) == set(reqs)
    for uid, t in toks.items():
        assert len(t) == reqs[uid].max_new_tokens
        assert t.min() >= 0 and t.max() < cfg.vocab
    for r in ranks:
        assert _equal(r["tp/tokens"], toks)
        assert r["tp/local_kv"][3] == cfg.n_kv_heads // 2
        np.testing.assert_allclose(r["tp/logits"], ref["tp/logits"], atol=1e-5, rtol=0)


def test_generate_on_mesh_equals_unsharded(world):
    ranks, ref = world
    for r in ranks:
        np.testing.assert_array_equal(r["generate"], ref["generate"])


def test_options_without_a_mesh_path_refuse(world):
    """spec= is refused as in the reference; faults= and slo= raise naming
    their ROADMAP items."""
    refusals = world[0][0]["refusals"]
    assert refusals["spec"].startswith("ValueError") and "mesh" in refusals["spec"]
    assert refusals["faults"].startswith("NotImplementedError") and "A.7a" in refusals["faults"]
    assert refusals["slo"].startswith("NotImplementedError") and "A.7b" in refusals["slo"]


def test_snapshot_resumes_across_mesh_shapes(world):
    """Elastic resume: a one-device snapshot cut mid-trace resumes onto the
    (2, 2) mesh, and a mesh snapshot onto one device; drained, each
    journal holds every request once with the uninterrupted tokens."""
    ranks, ref = world
    for key in ("onto_mesh", "off_mesh"):
        finished = ranks[0][key]
        assert sorted(uid for uid, _ in finished) == sorted(ref["uninterrupted"]), key
        assert _equal(dict(finished), ref["uninterrupted"]), key
    resumed = ranks[0]["resumed_on_mesh"]
    assert resumed and all(r["resumed_on_mesh"] == resumed for r in ranks)
