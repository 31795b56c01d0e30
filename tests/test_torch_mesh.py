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
references (the port's unsharded engines and logits, the JAX package's
engines on the port's weights) while the ranks run, and one more spawned
process the JAX package's tensor-parallel reference logits.  Each engine
run held to another admits by a deterministic clock of its own
(``_StepClock``), not the host's.  The models are smoke configs, in
their default bfloat16, where a row of a CPU product does not depend on
how many rows it is multiplied with, so a rank's block of slots computes
the bits the whole pool does; and in float32, where the port's engine is
held token-exact to the JAX package's (``tests/test_torch_engine.py``;
torch and XLA round bfloat16 products apart, so greedy bf16 tokens of the
two packages can part after a few steps).

Tolerances: exact-mode bf16 tokens bit-identical to the port's unsharded
engine (dense, ring, int8, every family: MoE, SSD, RG-LRU, LayerNorm, and
whisper-small through ``serve.generate``), with ``faults=`` (sqrt flips,
logit NaNs, dispatch failures) and with ``slo=`` (tokens, rung history,
counters); exact-mode float32 tokens equal to the JAX package's engine's
(dense and ring, and a rate-1.0 pinned-bit fault schedule); every rank's
host results identical.  Tensor parallel (the default ``serve_rules``):
the 'model' axis's partial sums reassociate, so the contract is integrity
(every request completes with its budget, tokens in the vocabulary, faults
included) and float32 logits (prefill and one decode step) within 1e-5 x
max(1, max |logit|) of the unsharded port's and of the JAX package's, for
each family and for experts over 'data'.  A MoE routing choice that flips
across the sum order (ROADMAP C.21) would hold that model on the unsharded
run's choices (``route(choices=)``); the count of flips is printed.
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


class _CudaMesh(MeshShape):
    """A mesh's names and sizes on the card, for the refusals that come
    before any device work."""

    device_type = "cuda"


def test_local_group_of_five_places_on_a_cuda_mesh(monkeypatch):
    """recurrentgemma-2b's 10 query heads a KV head over a 2-wide 'model'
    axis leave a rank 5 (one KV head, replicated), a group that
    ``decode_attention.cu`` runs as 6 with one head masked: ``place_model``
    takes it on a CUDA mesh with the fused kernel, each rank's window layer
    holds its 5 query heads over the whole KV head, and the kernel's wrapper
    accepts the rank's decode shapes.  The placement runs on each rank's
    mesh coordinates with no device: a block stays a meta tensor."""
    import itertools
    import types

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels.attention import ops as attn_ops

    cfg = get_config("recurrentgemma-2b", decode_kernel="fused")
    shape = _CudaMesh(("data", "model"), (2, 2))
    rules = serve_rules(cfg, shape)
    assert sharding.local_group(cfg, shape, rules) == 5
    assert sharding.local_group(cfg, shape, serve_rules(cfg, shape, replicate_params=True)) == 10
    monkeypatch.setattr(sharding, "_mesh_device", lambda mesh: torch.device("meta"))
    monkeypatch.setattr(sharding, "_dtensor",
                        lambda local, whole, sh: types.SimpleNamespace(to_local=lambda: local))
    model = lm.LM(cfg, device=torch.device("meta"))
    window = cfg.blocks.index("window")
    for coord in itertools.product(range(2), range(2)):
        class _Rank(_CudaMesh):
            def get_coordinate(self, coord=coord):
                return list(coord)

        local = sharding.place_model(model, cfg, _Rank(*shape), rules)
        attn = local.layers[window].attn
        assert tuple(attn.wq.shape) == (cfg.d_model, 5, cfg.d_head), coord
        assert tuple(attn.wk.shape) == (cfg.d_model, 1, cfg.d_head), coord
    with FakeTensorMode():
        q = torch.empty(8, 5, cfg.d_head, dtype=torch.bfloat16)
        k = torch.empty(8, cfg.window, 1, cfg.d_head, dtype=torch.bfloat16)
        attn_ops._check(q, k, k, torch.empty(8, dtype=torch.int32), None, None)


_DRY_CELL = """
import json
from repro_torch.configs.shapes import ShapeCase
from repro_torch.launch import dryrun
rec = dryrun.lower_cell("recurrentgemma-2b", "decode_32k", "single", mesh_shape=(2, 2),
                        case=ShapeCase("decode_32k", 64, 4, "decode"),
                        extra_overrides={"decode_kernel": "fused"})
print(json.dumps(rec))
"""


def test_dry_run_serves_the_local_group_of_five_on_the_kernel_route():
    """The dry run's decode cell of recurrentgemma-2b at full width on a
    (2, 2) mesh of fake ranks, the fused kernel on the fake-kernel route
    (a local group of 5): one ``decode_attention`` launch a window layer,
    one ``e2afs_sqrt`` an RG-LRU layer.  In a subprocess: ``lower_cell``
    joins a fake process group for the life of its process."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    res = subprocess.run([sys.executable, "-c", _DRY_CELL], capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=str(src), OMP_NUM_THREADS="1"),
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    cfg = get_config("recurrentgemma-2b")
    assert rec["status"] == "ok" and rec["n_chips"] == 4
    assert rec["launches"]["decode_attention"] == cfg.blocks.count("window") > 0
    assert rec["launches"]["e2afs_sqrt"] == cfg.blocks.count("rglru")


def test_fault_mask_of_a_block_is_the_slice_of_the_whole():
    """A (b, s, h, 1) qk-norm input cut over batch and heads (a tensor-
    parallel rank's block): each block's ``fault_mask`` at its global origin
    equals that slice of the whole tensor's, for every block and at every
    rate, through ``faults.block`` (the fault sites' route).  Past 2^32
    the index wraps as the reference's ``uint32`` arange: a block at global
    offset 2^32 + 5 of a (2^33,) tensor strikes as elements 5.. of the
    reference's own mask."""
    import jax.numpy as jnp
    from repro.core import faults as jax_faults

    from repro_torch.core import faults

    b, s, h = 4, 3, 6
    bits = torch.randint(0, 2**31 - 1, (b, s, h, 1), generator=torch.Generator().manual_seed(0))
    for rate in (0.3, 0.9):
        whole = faults.fault_mask(bits, rate, 11)
        np.testing.assert_array_equal(
            whole.numpy(), np.asarray(jax_faults.fault_mask(jnp.asarray(bits.numpy()), rate, 11)))
        for rows in ((0, 2), (2, 4)):
            for heads in ((0, 3), (3, 6)):
                blk = bits[rows[0]:rows[1], :, heads[0]:heads[1]]
                with faults.block((rows[0], 0, heads[0], 0), (b, s, h, 1)):
                    got = faults.fault_mask(blk, rate, 11)
                np.testing.assert_array_equal(
                    got.numpy(), whole[rows[0]:rows[1], :, heads[0]:heads[1]].numpy())
    small = torch.randint(0, 2**31 - 1, (13,), generator=torch.Generator().manual_seed(1))
    ref = np.asarray(jax_faults.fault_mask(jnp.asarray(small.numpy()), 0.5, 3))
    with faults.block((2**32 + 5,), (2**33,)):
        far = faults.fault_mask(small[5:], 0.5, 3)
    np.testing.assert_array_equal(far.numpy(), ref[5:])


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


class _StepClock:
    """A deterministic clock for ``Engine.run(clock=)``: reading k returns k
    steps.  A mesh run and the unsharded run it is held to, each on a clock
    of its own, admit their staggered requests in one order to the same
    slots, whatever the host's load (ROADMAP C.49)."""

    def __init__(self, step: float = 1e-3):
        self.step, self.reads = step, 0

    def __call__(self) -> float:
        self.reads += 1
        return (self.reads - 1) * self.step


def _run_trace(eng, vocab, n):
    """``eng.run`` over :func:`_requests` on a :class:`_StepClock`."""
    return eng.run(_requests(vocab, n), clock=_StepClock())


def _model(arch, **kw):
    """The smoke model of ``arch`` from seed 0, its constant starts moved
    (a fresh RG-LRU computes nothing; ROADMAP C.24)."""
    cfg = get_smoke_config(arch, sqrt_unit="e2afs", **kw)
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _, p in lm.constant_start_parameters(model):
            p.add_((0.1 * torch.randn(p.shape, generator=gen)).to(p.dtype))
    return cfg, model


def _tp_inputs(cfg):
    """(prompt (b, s), the decode step's tokens (b, 1), audio or None)."""
    gen = torch.Generator().manual_seed(1)
    b = TP_PROMPT[0]
    prompt = torch.randint(0, cfg.vocab, TP_PROMPT, generator=gen)
    tok = torch.randint(0, cfg.vocab, (b, 1), generator=gen)
    audio = (torch.randn((b, cfg.encoder.n_ctx, cfg.d_model), generator=gen)
             if cfg.kind == "encdec" else None)
    return prompt, tok, audio


class _Routing:
    """Record every ``moe.route`` call's choices (``record``), or hold the
    calls to given ones (``replay``, the whole batch's; a rank takes its
    rows)."""

    def __init__(self, replay=None):
        self.record, self.replay = [], list(replay) if replay is not None else None

    def __enter__(self):
        from repro_torch.distributed.constraints import block_origin
        from repro_torch.layers import moe

        self._route = plain = moe.route

        def route(router, x, k, cap, choices=None):
            if self.replay is not None:
                (r0,), _ = block_origin(("batch",), (x.shape[0],))
                choices = self.replay.pop(0)[r0:r0 + x.shape[0]]
            out = plain(router, x, k, cap, choices)
            self.record.append(out[2])
            return out

        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.layers import moe

        moe.route = self._route


def _tp_logits(cfg, model, mesh=None, rules=None):
    """Prefill and one decode step of ``model`` (float32) over
    :func:`_tp_inputs`: (prefill logits (b, s, V), step logits (b, 1, V)),
    the whole batch.  With a mesh, ``model`` is placed by ``rules`` and the
    rows are the rank's."""
    from repro_torch.distributed.constraints import maybe_axis_rules

    prompt, tok, audio = _tp_inputs(cfg)
    cache = lm.init_cache(cfg, TP_PROMPT[0], TP_CACHE, device="cpu")
    if mesh is not None:
        model = sharding.place_model(model, cfg, mesh, rules)
        like = lm.init_cache(cfg, TP_PROMPT[0], TP_CACHE, abstract=True)
        cache = sharding.local_tree(sharding.zeros_tree(like, sharding.shardings_for(
            lm.cache_specs(cfg), mesh, rules, like)))
        rows = sharding.shardings_for(("batch", None), mesh, rules, prompt)
        prompt, tok = sharding.place(prompt, rows).to_local(), sharding.place(tok, rows).to_local()
        if audio is not None:
            audio = sharding.place(audio, sharding.shardings_for(
                ("batch", None, None), mesh, rules, audio)).to_local()
    ckv = None if audio is None else lm.precompute_cross(model, cfg, audio, mesh=mesh,
                                                         rules=rules)[0]
    first, cache = lm.prefill(model, cfg, cache, prompt, cross_kv=ckv, mesh=mesh, rules=rules)
    with maybe_axis_rules(mesh, rules):
        step, _ = lm.decode_step(model, cfg, cache, tok, TP_PROMPT[1], cross_kv=ckv)
    if mesh is not None:
        out = sharding.shardings_for(("batch", None, None), mesh, rules, first)
        first, step = sharding.gather(first, out), sharding.gather(step, out)
    return first.numpy(), step.numpy()


def _tp_family(mesh, arch, expert) -> dict:
    """The rank's side of a TP logits case: the gathered logits and, for
    experts, the routing flips against the unsharded run (then the logits
    held to its choices)."""
    cfg, model = _model(arch, act_dtype="float32")
    rules = serve_rules(cfg, mesh)
    if expert is not None:
        rules["expert"] = expert
    if cfg.moe is None:
        return {"logits": _tp_logits(cfg, model, mesh, rules), "flips": None}
    with _Routing() as plain:
        _tp_logits(cfg, model)
    with _Routing() as free:
        logits = _tp_logits(cfg, model, mesh, rules)
    from repro_torch.distributed.constraints import block_origin, maybe_axis_rules

    flips = 0
    with maybe_axis_rules(mesh, rules):
        for a, b in zip(plain.record, free.record):
            (r0,), _ = block_origin(("batch",), (b.shape[0],))
            flips += int((a[r0:r0 + b.shape[0]] != b).sum())
    if flips:
        with _Routing(replay=plain.record):
            logits = _tp_logits(cfg, model, mesh, rules)
    return {"logits": logits, "flips": flips}


# (arch, slots, requests, quantized): 4 slots, one a rank; 2 slots, over
# 'data' and replicated over 'model'; 3 slots, indivisible, replicated; and
# each family the port serves, 4 slots
FAMILIES = ("mixtral-8x22b", "qwen3-moe-235b-a22b", "mamba2-2.7b", "recurrentgemma-2b",
            "gemma3-1b", "starcoder2-15b", "whisper-small")
EXACT = (("qwen3-4b", 4, 7, False), ("gemma3-1b", 2, 7, False), ("qwen3-4b", 3, 5, True),
         ("mixtral-8x22b", 4, 5, False), ("qwen3-moe-235b-a22b", 4, 5, False),
         ("mamba2-2.7b", 4, 5, False), ("recurrentgemma-2b", 4, 5, False),
         ("starcoder2-15b", 4, 5, False))
# tensor-parallel logits: (arch, rules["expert"] override)
TP = tuple((arch, None) for arch in FAMILIES) + (("qwen3-moe-235b-a22b", "data"),)
TP_CACHE = 12
# the fault schedules the exact mode serves (bf16 qwen3-4b, 4 slots)
FAULTS = {"sqrt": dict(site="sqrt_man", rate=0.3, seed=3),
          "nan": dict(site="logit_nan", rate=0.5, seed=1),
          "dispatch": dict(site="dispatch", rate=0.4, seed=5)}
FAULT_KW = {"nan": dict(quarantine_retries=1)}
# float32 against the JAX package: a rate-1.0 pinned-bit schedule (C.17)
PINNED = dict(site="sqrt_man", rate=1.0, seed=7, bit=5)
# the accuracy SLO under pressure: canaries every other step demote the
# struck slots, clean streaks promote them
PRESSURE = dict(site="sqrt_man", rate=1.0, seed=7, bit=21)
SLO = dict(canary_stride=2, rel_err_budget=0.05, divergence_budget=0, promote_after=2)
COUNTERS = ("faults_detected", "quarantine_retries", "exact_fallbacks", "dispatch_faults",
            "dispatch_retries", "canary_checks", "canary_divergences", "canary_max_rel_err",
            "demotions", "promotions", "n_ok", "n_degraded", "n_failed")
# (arch, slots): float32, against the JAX package's engine
EXACT_F32 = (("qwen3-4b", 4), ("gemma3-1b", 2))
TP_PROMPT = (4, 6)


def _tokens(done) -> dict:
    return {uid: np.asarray(c.tokens) for uid, c in done.items()}


def _served(eng, done) -> dict:
    """What an engine under faults or an SLO must reproduce: each request's
    tokens, status, trips and rung trail, and the run's counters."""
    return {"tokens": _tokens(done),
            "audit": {uid: (c.status, c.trips, c.unit_final, c.canary_checks,
                            c.canary_divergences, repr(c.unit_trips))
                      for uid, c in done.items()},
            "counters": {k: eng.stats[k] for k in COUNTERS}}


def _telemetry(path) -> list:
    """The telemetry's chunk records without their clock fields."""
    from repro_torch.launch.telemetry import read_telemetry

    return [{k: v for k, v in r.items() if k not in ("t", "tok_s")}
            for r in read_telemetry(path) if r.get("kind") == "chunk"]


def _finished(path) -> list:
    """(uid, tokens) of every ``finished`` record of a journal."""
    from repro_torch.launch.journal import read_journal

    return [(r["uid"], np.asarray(r["tokens"], np.int32))
            for r in read_journal(path) if r["kind"] == "finished"]


def _rank_scenarios(rank: int, tmp: str) -> dict:
    """Every multi-rank scenario, in one order on every rank."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.perf_counter()
    mesh = make_production_mesh(shape=(2, 2), device="cpu")
    out = {"coordinate": tuple(mesh.get_coordinate())}
    kw = dict(cache_len=CACHE, chunk=3)

    for arch, slots, n, quantized in EXACT:
        cfg, model = _model(arch)
        eng = Engine(model, cfg, num_slots=slots, quantized_kv=quantized, mesh=mesh,
                     rules=serve_rules(cfg, mesh, replicate_params=True), **kw)
        eng.warmup(prompt_lens={3, 5})
        out[f"exact/{arch}/{slots}"] = _tokens(_run_trace(eng, cfg.vocab, n))
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
        out[f"f32/{arch}"] = _tokens(_run_trace(eng, cfg.vocab, 7))

    # tensor parallel: the engine's integrity, and float32 first-step logits
    cfg, model = _model("qwen3-4b")
    eng = Engine(model, cfg, num_slots=4, mesh=mesh, rules=serve_rules(cfg, mesh), **kw)
    eng.warmup(prompt_lens={3, 5})
    out["tp/tokens"] = _tokens(_run_trace(eng, cfg.vocab, 6))
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

    # serve.generate on the mesh, exact rules (whisper-small with its audio)
    for arch in ("qwen3-4b", "whisper-small"):
        gcfg = get_smoke_config(arch, sqrt_unit="e2afs")
        out[f"generate/{arch}"] = serve.generate(
            arch, batch=4, prompt_len=5, gen_len=6, reps=1, verbose=False, device="cpu",
            mesh=mesh, rules=serve_rules(gcfg, mesh, replicate_params=True))[0].numpy()

    # every family under the default tensor-parallel rules: float32 logits
    for arch, expert in TP:
        out[f"tp/{arch}/{expert}"] = _tp_family(mesh, arch, expert)
    # every model id places, and an Engine takes it, under both rule tables
    placed = {}
    for arch in LM_IDS:
        pcfg, pmodel = _model(arch)
        for name, prules in (("tp", serve_rules(pcfg, mesh)),
                             ("exact", serve_rules(pcfg, mesh, replicate_params=True))):
            Engine(pmodel, pcfg, num_slots=4, mesh=mesh, rules=prules, **kw)
            placed[f"{arch}/{name}"] = True
    out["placed"] = placed
    # experts over 'data' in the engine: every rank runs each admission
    mcfg, mmodel = _model("qwen3-moe-235b-a22b")
    mrules = serve_rules(mcfg, mesh)
    mrules["expert"] = "data"
    eng = Engine(mmodel, mcfg, num_slots=4, mesh=mesh, rules=mrules, **kw)
    out["tp/expert-data/tokens"] = _tokens(_run_trace(eng, mcfg.vocab, 5))

    # faults= and slo= on the mesh
    from repro_torch.core.faults import FaultConfig
    from repro_torch.launch.engine import AccuracySLO

    exact = serve_rules(cfg, mesh, replicate_params=True)
    for name, fc in FAULTS.items():
        eng = Engine(model, cfg, num_slots=4, mesh=mesh, rules=exact,
                     faults=FaultConfig(**fc), **FAULT_KW.get(name, {}), **kw)
        out[f"faults/{name}"] = _served(eng, _run_trace(eng, cfg.vocab, 6))
    eng = Engine(model, cfg, num_slots=4, mesh=mesh, rules=serve_rules(cfg, mesh),
                 faults=FaultConfig(**FAULTS["sqrt"]), **kw)
    out["faults/tp"] = _tokens(_run_trace(eng, cfg.vocab, 6))
    eng = Engine(model32, cfg32, num_slots=4, mesh=mesh, faults=FaultConfig(**PINNED),
                 rules=serve_rules(cfg32, mesh, replicate_params=True), **kw)
    out["faults/pinned_f32"] = _tokens(_run_trace(eng, cfg32.vocab, 7))
    tele = os.path.join(tmp, "telemetry-mesh.jsonl")
    eng = Engine(model, cfg, num_slots=4, mesh=mesh, rules=exact, faults=FaultConfig(**PRESSURE),
                 slo=AccuracySLO(**SLO), telemetry=tele, **kw)
    out["slo"] = _served(eng, _run_trace(eng, cfg.vocab, 6))
    if rank == 0:
        out["slo/telemetry"] = _telemetry(tele)

    # spec= still refuses a mesh; faults= and slo= do not
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
    out["seconds"] = time.perf_counter() - t0
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


def _references(tmp) -> dict:
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
        ref.update(_port_references(tmp))
    finally:
        torch.set_num_threads(threads)
    from repro.core.faults import FaultConfig as JaxFaultConfig

    for arch, faults in [(a, None) for a, _ in EXACT_F32] + [("qwen3-4b", PINNED)]:
        cfg, model = _model(arch, act_dtype="float32")
        params = jax.tree.map(jax.numpy.asarray, convert.params_to_numpy(model))
        jreqs = [JaxRequest(uid=r.uid, prompt=r.prompt, max_new_tokens=r.max_new_tokens,
                            arrival_s=r.arrival_s) for r in _requests(cfg.vocab, 7)]
        jeng = JaxEngine(params, jax_smoke(arch, sqrt_unit="e2afs", act_dtype="float32"),
                         num_slots=2, faults=faults and JaxFaultConfig(**faults), **kw)
        ref[f"jax/{arch}" + ("/pinned" if faults else "")] = _tokens(jeng.run(jreqs))
    return ref


def _jax_main(tmp: str) -> None:
    """The JAX package's unsharded float32 logits of every family over
    :func:`_tp_inputs` on the port's weights (prefill, then one decode
    step; one jitted call a family), in a process beside the parent's,
    pickled to ``jax_tp.pkl``."""
    import functools

    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.models import lm as jax_lm

    torch.set_num_threads(1)

    @functools.partial(jax.jit, static_argnums=1)
    def logits(params, jcfg, cache, prompt, tok, audio):
        ckv = None if audio is None else jax_lm.precompute_cross(params, jcfg, audio)[0]
        first, cache = jax_lm.prefill(params, jcfg, cache, prompt, cross_kv=ckv)
        step, _ = jax_lm.decode_step(params, jcfg, cache, tok, jnp.int32(TP_PROMPT[1]),
                                     cross_kv=ckv)
        return first, step

    out = {}
    for arch in FAMILIES:
        cfg, model = _model(arch, act_dtype="float32")
        params = jax.tree.map(jnp.asarray, convert.params_to_numpy(model))
        jcfg = jax_smoke(arch, sqrt_unit="e2afs", act_dtype="float32")
        cache, _ = jax_lm.init_cache(jcfg, TP_PROMPT[0], TP_CACHE)
        inputs = (None if t is None else jnp.asarray(t.numpy()) for t in _tp_inputs(cfg))
        out[f"jax/tp/{arch}"] = tuple(np.asarray(x, np.float32)
                                      for x in logits(params, jcfg, cache, *inputs))
    with open(os.path.join(tmp, "jax_tp.pkl"), "wb") as f:
        pickle.dump(out, f)


def _port_references(tmp) -> dict:
    ref = {}
    kw = dict(cache_len=CACHE, chunk=3)
    for arch, slots, n, quantized in EXACT:
        cfg, model = _model(arch)
        ref[f"exact/{arch}/{slots}"] = _tokens(_run_trace(
            Engine(model, cfg, num_slots=slots, quantized_kv=quantized, **kw), cfg.vocab, n))
    cfg, model = _model("qwen3-4b")
    ref["uninterrupted"] = _tokens(Engine(model, cfg, num_slots=4, **kw).run(
        _requests(cfg.vocab, 4, stagger=False)))
    cfg32, model32 = _model("qwen3-4b", act_dtype="float32")
    prompt = torch.randint(0, cfg32.vocab, TP_PROMPT, generator=torch.Generator().manual_seed(1))
    logits, _ = lm.prefill(model32, cfg32, lm.init_cache(cfg32, TP_PROMPT[0], 16, device="cpu"),
                           prompt)
    ref["tp/logits"] = logits.numpy()
    for arch in ("qwen3-4b", "whisper-small"):
        ref[f"generate/{arch}"] = serve.generate(arch, batch=4, prompt_len=5, gen_len=6, reps=1,
                                                 verbose=False, device="cpu")[0].numpy()
    for arch in FAMILIES:
        ref[f"tp/{arch}"] = _tp_logits(*_model(arch, act_dtype="float32"))
    from repro_torch.core.faults import FaultConfig
    from repro_torch.launch.engine import AccuracySLO

    for name, fc in FAULTS.items():
        eng = Engine(model, cfg, num_slots=4, faults=FaultConfig(**fc),
                     **FAULT_KW.get(name, {}), **kw)
        ref[f"faults/{name}"] = _served(eng, _run_trace(eng, cfg.vocab, 6))
    tele = os.path.join(tmp, "telemetry-one.jsonl")
    eng = Engine(model, cfg, num_slots=4, faults=FaultConfig(**PRESSURE), slo=AccuracySLO(**SLO),
                 telemetry=tele, **kw)
    ref["slo"] = _served(eng, _run_trace(eng, cfg.vocab, 6))
    ref["slo/telemetry"] = _telemetry(tele)
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
    helper = mp.get_context("spawn").Process(target=_jax_main, args=(str(tmp),))
    helper.start()
    try:
        ref = _references(str(tmp))
        ref["seconds"] = time.perf_counter() - t0
        helper.join(timeout=max(1.0, 240 - (time.perf_counter() - t0)))
        if helper.exitcode != 0:
            raise RuntimeError(f"the JAX helper process ended with {helper.exitcode}")
        while not ctx.join(timeout=0.5):
            if time.perf_counter() - t0 > 240:
                raise TimeoutError("the 4-rank world did not finish in 240 s")
    finally:
        for p in ctx.processes + [helper]:
            if p.is_alive():
                p.terminate()
    with open(tmp / "jax_tp.pkl", "rb") as f:
        ref.update(pickle.load(f))
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, ref


def _equal(a: dict, b: dict) -> bool:
    return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)


def test_world_coordinates_are_data_major(world):
    ranks, ref = world
    print(f"world: ranks {[round(r['seconds'], 1) for r in ranks]} s, parent "
          f"{ref['seconds']:.1f} s")
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
    """``serve.generate(mesh=)`` in exact mode: qwen3-4b, and whisper-small
    with its audio through the encoder, the unsharded tokens on every
    rank."""
    ranks, ref = world
    for arch in ("qwen3-4b", "whisper-small"):
        for r in ranks:
            np.testing.assert_array_equal(r[f"generate/{arch}"], ref[f"generate/{arch}"])


def test_options_without_a_mesh_path_refuse(world):
    """spec= is still refused on a mesh, as in the reference; faults= and
    slo= now build an engine on it."""
    refusals = world[0][0]["refusals"]
    assert refusals["spec"].startswith("ValueError") and "mesh" in refusals["spec"]
    assert refusals["faults"] is None and refusals["slo"] is None


@pytest.mark.parametrize("arch,expert", TP)
def test_tp_logits_per_family(world, arch, expert):
    """Float32 under the default ``serve_rules`` (experts over 'data' for
    the override): prefill and one decode step's logits on every rank within
    1e-5 x max(1, max |logit|) of the unsharded port's and of the JAX
    package's on the same weights and inputs.  A MoE model's routing flips
    (none expected) are printed, and the logits are then held on the
    unsharded run's choices."""
    ranks, ref = world
    want, jax_want = ref[f"tp/{arch}"], ref[f"jax/tp/{arch}"]
    for r in ranks:
        got = r[f"tp/{arch}/{expert}"]
        if got["flips"] is not None:
            print(f"{arch} (experts over {expert}): {got['flips']} routing choices flip on rank "
                  f"{r['coordinate']}")
        for g, w, j in zip(got["logits"], want, jax_want):
            assert g.shape == w.shape == j.shape
            tol = 1e-5 * max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g, w, atol=tol, rtol=0)
            np.testing.assert_allclose(g, j, atol=tol, rtol=0)


def test_every_model_id_places_under_both_rule_tables(world):
    """``place_model`` and ``Engine(mesh=)`` take every model id under the
    default tensor-parallel rules and under exact mode on the (2, 2) world
    (the CPU runs no kernel, so no local group is refused)."""
    for r in world[0]:
        assert r["placed"] == {f"{a}/{m}": True for a in LM_IDS for m in ("tp", "exact")}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_faults_in_exact_mode_match_the_unsharded_engine(world, name):
    """Exact mode under ``faults=``: sqrt mantissa flips at rate 0.3 (each
    element hashed at its global index), logit NaNs at rate 0.5 (quarantine,
    the exact fallback) and dispatch failures at rate 0.4 (retries): the
    unsharded engine's tokens, statuses, trips and counters on every
    rank."""
    ranks, ref = world
    want = ref[f"faults/{name}"]
    if name == "nan":
        assert want["counters"]["faults_detected"] > 0
    if name == "dispatch":
        assert want["counters"]["dispatch_retries"] > 0
    for r in ranks:
        got = r[f"faults/{name}"]
        assert _equal(got["tokens"], want["tokens"]), (name, r["coordinate"])
        assert got["audit"] == want["audit"] and got["counters"] == want["counters"]


def test_admissions_follow_the_run_clock_not_the_host(monkeypatch, tmp_path):
    """ROADMAP C.49: under ``Engine.run(clock=_StepClock())`` the staggered
    trace of the fault tests is admitted to the same slots at the same
    times, with the same tokens under sqrt faults (whose strikes follow the
    slot rows), whether the host's wall clock runs, jumps 10 s a reading (a
    loaded host) or stalls.  On the wall clock the jumping host admits
    otherwise: the engine reads the clock it is given and no other."""
    import types

    from repro_torch.core.faults import FaultConfig
    from repro_torch.launch import engine as engine_mod
    from repro_torch.launch.journal import read_journal

    cfg, model = _model("qwen3-4b")
    reqs = _requests(cfg.vocab, 6)

    def host(step):
        reads = iter(range(10**9))
        return lambda: next(reads) * step

    def admissions(name, wall=None, clock=None):
        journal = tmp_path / f"{name}.jsonl"
        eng = Engine(model, cfg, num_slots=4, faults=FaultConfig(**FAULTS["sqrt"]),
                     journal=str(journal), cache_len=CACHE, chunk=3)
        with monkeypatch.context() as patch:
            if wall is not None:
                patch.setattr(engine_mod, "time",
                              types.SimpleNamespace(perf_counter=wall, sleep=lambda s: None))
            done = eng.run(reqs, clock=clock, deadline_s=1e9)
        slots = {r["uid"]: r["slot"] for r in read_journal(journal) if r["kind"] == "admitted"}
        return slots, {u: c.admitted_s for u, c in done.items()}, _tokens(done)

    want = admissions("wall", clock=_StepClock())
    assert sorted(want[0]) == [r.uid for r in reqs] and len(set(want[0].values())) == 4
    for name, step in (("jump", 10.0), ("stall", 0.0)):
        got = admissions(name, wall=host(step), clock=_StepClock())
        assert got[0] == want[0] and got[1] == want[1], name
        assert _equal(got[2], want[2]), name
    on_wall = admissions("jump-on-wall", wall=host(10.0))
    assert on_wall[1] != want[1]


def test_pinned_faults_token_exact_against_the_jax_engine(world):
    """Float32 exact mode under a rate-1.0 pinned-bit sqrt schedule serves
    the JAX package's unsharded faulted engine's tokens (C.17)."""
    ranks, ref = world
    for r in ranks:
        assert _equal(r["faults/pinned_f32"], ref["jax/qwen3-4b/pinned"]), r["coordinate"]


def test_faults_under_tp_and_experts_over_data_keep_integrity(world):
    """Tensor parallel with sqrt faults, and a MoE engine with experts over
    'data' (every rank runs each admission): every request completes with
    its budget, tokens in the vocabulary, the same on every rank."""
    ranks, _ = world
    for key, arch, n in (("faults/tp", "qwen3-4b", 6),
                         ("tp/expert-data/tokens", "qwen3-moe-235b-a22b", 5)):
        cfg = get_smoke_config(arch)
        reqs = {r.uid: r for r in _requests(cfg.vocab, n)}
        toks = ranks[0][key]
        assert set(toks) == set(reqs), key
        for uid, t in toks.items():
            assert len(t) == reqs[uid].max_new_tokens and t.min() >= 0 and t.max() < cfg.vocab
        assert all(_equal(r[key], toks) for r in ranks), key


def test_slo_in_exact_mode_bit_identical_to_unsharded(world):
    """``Engine(mesh=, slo=)`` in exact mode, canaries every other step under
    a pinned high-bit sqrt schedule: the unsharded SLO engine's tokens, each
    request's rung history and canary audit, the counters and rank 0's
    telemetry records (clock fields aside), bit for bit."""
    ranks, ref = world
    want = ref["slo"]
    assert want["counters"]["demotions"] > 0 and want["counters"]["canary_checks"] > 0
    for r in ranks:
        assert _equal(r["slo"]["tokens"], want["tokens"]), r["coordinate"]
        assert r["slo"]["audit"] == want["audit"] and r["slo"]["counters"] == want["counters"]
    assert ranks[0]["slo/telemetry"] == ref["slo/telemetry"]


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
