"""The port's dry run held against the JAX package's: the cells' shapes and
policies, the prefill and serve steps, and the op count against
``repro.launch.hlo_cost``.

* ``SHAPES``, ``SMOKE_SHAPES``, ``shape_applies``, ``long_context_capable``
  and ``input_specs`` (shapes and dtypes) equal the reference's for every
  LM arch; the quantized-KV estimate equals ``_decode_hbm_estimate_gib``
  for every arch, decode shape and production mesh shape (to 1e-12
  relative).
* ``make_prefill_step`` / ``make_serve_step`` float32 logits at smoke width
  match the JAX package's (the port's weights carried over with
  ``models/convert.py``) within atol 1e-4: sums in another order.
* ``op_cost``'s dot flops for the smoke prefill step within 2% of
  ``analyze_hlo`` on the JAX step compiled for the CPU.
* ``op_cost`` on ``tests/launch/test_hlo_cost.py``'s four programs.
* One subprocess runs the CLI with ``--smoke --mesh both`` on the
  reference test's decode cells (mamba2-2.7b and whisper-small
  ``decode_32k``), on 4 and 8 fake ranks.
* The train cells (the sharded train step under ``train_rules``): seven
  CLI subprocesses, started together, run every LM arch's smoke
  ``train_4k`` cell on both meshes (one of them the reference test's
  cells, qwen3-4b and mixtral-8x22b); an eighth lowers a qwen3-4b train
  cell on one rank (``remat none``), whose dot flops are held within 2%
  of ``analyze_hlo`` on the JAX package's train step compiled for the CPU,
  and runs the CLI's train options (``--microbatches``, ``--remat``); a
  ninth runs the reference test's cells with ``--seq-parallel``.
"""
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.configs import shapes as jax_shapes
from repro.launch import steps as jax_steps
from repro.launch.hlo_cost import analyze_hlo
from repro.models import lm as jax_lm
from repro_torch.configs import get_config, get_smoke_config, shapes
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import dryrun, op_cost, steps
from repro_torch.models import convert, lm

REPO = Path(__file__).resolve().parents[1]
ARCHS = dryrun.LM_ARCHS


@pytest.fixture(scope="module")
def jax_dryrun():
    """``repro.launch.dryrun``, imported without its forced 512 host devices
    leaking into this process (it sets XLA_FLAGS at import; JAX reads the
    variable when its backend starts)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _dtype_name(dt) -> str:
    return str(dt).removeprefix("torch.") if isinstance(dt, torch.dtype) else np.dtype(dt).name


# ---------------------------------------------------------------------------
# shapes and policies
# ---------------------------------------------------------------------------


def test_shape_tables_equal_reference():
    for port, ref in ((shapes.SHAPES, jax_shapes.SHAPES),
                      (shapes.SMOKE_SHAPES, jax_shapes.SMOKE_SHAPES)):
        assert list(port) == list(ref)
        for name in port:
            p, r = port[name], ref[name]
            assert (p.name, p.seq_len, p.global_batch, p.kind) == (
                r.name, r.seq_len, r.global_batch, r.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_policies_and_input_specs_equal_reference(arch):
    for getter, jgetter, table in ((get_config, jax_get_config, shapes.SHAPES),
                                   (get_smoke_config, jax_smoke_config, shapes.SMOKE_SHAPES)):
        cfg, jcfg = getter(arch), jgetter(arch)
        assert cfg.long_context_capable == jcfg.long_context_capable
        for name, case in table.items():
            assert shapes.shape_applies(cfg, name) == jax_shapes.shape_applies(jcfg, name)
            port = shapes.input_specs(cfg, case)
            ref = jax_shapes.input_specs(jcfg, jax_shapes.SHAPES[name] if table is shapes.SHAPES
                                         else jax_shapes.SMOKE_SHAPES[name])
            assert list(port) == list(ref)
            for k in port:
                assert port[k].device.type == "meta"
                assert tuple(port[k].shape) == tuple(ref[k].shape)
                assert _dtype_name(port[k].dtype) == _dtype_name(ref[k].dtype)
            if case.kind == "decode":
                assert shapes.cache_len_for(cfg, case) == jax_shapes.cache_len_for(
                    jcfg, jax_shapes.SHAPES[name] if table is shapes.SHAPES
                    else jax_shapes.SMOKE_SHAPES[name])


def _production_meshes(cfg):
    meshes = [(("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16))]
    kvh = cfg.n_kv_heads
    if 1 < kvh < 16 and 16 % kvh == 0:
        meshes += [(("data", "kv", "qg"), (16, kvh, 16 // kvh)),
                   (("pod", "data", "kv", "qg"), (2, 16, kvh, 16 // kvh))]
    return meshes


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_hbm_estimate_equals_reference(arch, jax_dryrun):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for name in ("decode_32k", "long_500k"):
        for axes, shape in _production_meshes(cfg):
            jmesh = types.SimpleNamespace(shape=dict(zip(axes, shape)), axis_names=axes)
            want = jax_dryrun._decode_hbm_estimate_gib(jcfg, jax_shapes.SHAPES[name], jmesh)
            got = dryrun.decode_hbm_estimate_gib(cfg, shapes.SHAPES[name], MeshShape(axes, shape))
            np.testing.assert_allclose(got, want, rtol=1e-12)


def test_quantize_threshold_is_h100_share():
    assert dryrun.QUANTIZE_ABOVE_GIB == pytest.approx(80e9 / 2**30 * 14 / 16)
    assert round(dryrun.QUANTIZE_ABOVE_GIB, 1) == 65.2


# ---------------------------------------------------------------------------
# the steps against the reference's, and the op count against analyze_hlo
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke_pair():
    # the exact unit: the steps are the point here (the e2afs unit's parity is
    # tests/test_torch_model.py's), and the reference's exact forward compiles
    # in a fraction of its e2afs one's time
    jcfg = jax_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit="exact")
    tcfg = get_smoke_config("qwen3-4b", act_dtype="float32", sqrt_unit="exact")
    # the port draws the weights (the reference's eager init compiles each
    # draw) and they cross over as numpy arrays
    model = lm.init(tcfg, torch.Generator().manual_seed(0), device="cpu")
    params = jax.tree.map(jnp.asarray, convert.params_to_numpy(model))
    case = shapes.SMOKE_SHAPES["prefill_32k"]
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab, (case.global_batch, case.seq_len))
    return jcfg, tcfg, params, model, tokens.astype(np.int32)


@pytest.fixture(scope="module")
def jax_prefill(smoke_pair):
    jcfg, _, params, _, tokens = smoke_pair
    batch = {"tokens": jnp.asarray(tokens)}
    compiled = jax.jit(jax_steps.make_prefill_step(jcfg)).lower(params, batch).compile()
    return compiled, np.asarray(compiled(params, batch))


def test_prefill_step_logits_match_reference(smoke_pair, jax_prefill):
    _, tcfg, _, model, tokens = smoke_pair
    got = steps.make_prefill_step(tcfg)(model, {"tokens": torch.from_numpy(tokens)})
    want = jax_prefill[1]
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_serve_step_logits_match_reference(smoke_pair):
    jcfg, tcfg, params, model, tokens = smoke_pair
    b, t = 2, 16
    jcache, _ = jax_lm.init_cache(jcfg, b, t)
    tcache = lm.init_cache(tcfg, b, t, device="cpu")
    jstep = jax.jit(jax_steps.make_serve_step(jcfg))
    tstep = steps.make_serve_step(tcfg)
    for pos in range(3):
        tok = tokens[:b, pos:pos + 1]
        jlogits, jcache = jstep(params, jcache, jnp.asarray(tok), pos)
        tlogits, tcache = tstep(model, tcache, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), atol=1e-4, rtol=0)


def test_op_cost_dot_flops_within_2pct_of_analyze_hlo(smoke_pair, jax_prefill):
    _, tcfg, _, model, tokens = smoke_pair
    _, cost = op_cost.count(steps.make_prefill_step(tcfg), model,
                            {"tokens": torch.from_numpy(tokens)})
    want = analyze_hlo(jax_prefill[0].as_text()).flops
    assert cost.flops == pytest.approx(want, rel=0.02)


# tests/launch/test_hlo_cost.py's four programs, counted by op_cost


def test_op_cost_loop_free_dot_matches_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    w, x = torch.ones(256, 512), torch.ones(64, 256)
    _, cost = op_cost.count(lambda: x @ w)
    with FlopCounterMode(display=False) as fc:
        x @ w
    assert cost.flops == pytest.approx(fc.get_total_flops(), rel=0.01)


def test_op_cost_counts_every_iteration():
    w, x = torch.ones(128, 128), torch.ones(128)

    def looped():
        y = x
        for _ in range(16):
            y = w @ y
        return y

    _, cost = op_cost.count(looped)
    assert cost.flops == pytest.approx(2 * 128 * 128 * 16, rel=0.05)


def test_op_cost_nested_loops():
    w = torch.ones(64, 64)

    def nested():
        c = torch.ones(64)
        for _ in range(3):
            for _ in range(4):
                c = w @ c
        return c

    _, cost = op_cost.count(nested)
    assert cost.flops == pytest.approx(2 * 64 * 64 * 12, rel=0.05)


def test_op_cost_bytes_nonzero_and_scaled_by_loop():
    x = torch.ones(1024, 1024)

    def looped():
        c = x
        for _ in range(8):
            c = c * 2.0 + 1.0
        return c

    _, cost = op_cost.count(looped)
    assert cost.bytes > 8 * 4 * 1024 * 1024


# ---------------------------------------------------------------------------
# the CLI: the reference test's decode cells on 4 and 8 fake ranks
# ---------------------------------------------------------------------------


def test_cli_smoke_decode_cells(tmp_path):
    out = tmp_path / "cells"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-2.7b",
           "whisper-small", "--shape", "decode_32k", "--mesh", "both", "--smoke",
           "--attribute", "3", "--out", str(out)]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "jax" not in res.stderr
    for arch in ("mamba2-2.7b", "whisper-small"):
        for mesh, n in (("single", 4), ("multi", 8)):
            rec = json.loads((out / f"{arch}_decode_32k_{mesh}.json").read_text())
            assert rec["status"] == "ok", rec["status"]
            assert rec["n_chips"] == n and rec["chip"] == "nvidia-h100-sxm"
            assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
            assert rec["memory"]["peak_estimate_bytes"] > 0
            assert rec["launches"] and rec["top_bytes"]
            assert rec["roofline"]["dominant"] in ("compute_s", "memory_s", "collective_s")


def test_port_tooling_imports_no_jax():
    code = ("import sys; import repro_torch.launch.dryrun, repro_torch.kernels.tuning, "
            "repro_torch.launch.steps, repro_torch.distributed.sharding, "
            "repro_torch.distributed.constraints, repro_torch.optim; "
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


# ---------------------------------------------------------------------------
# the train cells: every LM arch's smoke train_4k cell on both meshes, a
# train cell's dot flops against analyze_hlo, and the CLI's train options
# ---------------------------------------------------------------------------

# the CLI's groups of (archs, meshes), one subprocess each, all started
# together and balanced by their cells' seconds (the first: the reference
# test's train cells)
TRAIN_GROUPS = ((("qwen3-4b", "mixtral-8x22b"), "both"),
                (("whisper-small", "internvl2-76b"), "single"),
                (("whisper-small", "internvl2-76b"), "multi"),
                (("gemma3-1b", "mamba2-2.7b"), "single"),
                (("gemma3-1b", "mamba2-2.7b"), "multi"),
                (("recurrentgemma-2b", "starcoder2-15b"), "both"),
                (("qwen3-moe-235b-a22b", "deepseek-67b"), "both"))
# the one-rank train cell held against the reference's step, and the
# options' cells (a fourth subprocess)
_ONE_RANK = """
import json, sys
from repro_torch.launch import dryrun
dryrun.main(["--arch", "qwen3-4b", "--shape", "train_4k", "--mesh", "single", "--smoke",
             "--microbatches", "2", "--remat", "minimal", "--out", sys.argv[1]])
rec = dryrun.lower_cell("qwen3-4b", "train_4k", "single", mesh_shape=(1, 1), smoke=True,
                        sqrt_unit="exact", extra_overrides={"remat": "none"})
print(json.dumps(rec))
"""


def _port_env():
    # one thread a subprocess: fake tensors compute nothing, and nine run at once
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def train_cells(tmp_path_factory):
    """Start the subprocesses together, compile the reference's one-device
    train step meanwhile; returns (the CLI groups' records by (arch, mesh),
    their (returncode, stderr), the one-rank record, the options' record,
    the reference's dot flops, the ``--seq-parallel`` records by tag)."""
    tmp = tmp_path_factory.mktemp("train_cells")
    procs = []
    for i, (archs, meshes) in enumerate(TRAIN_GROUPS):
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", *archs, "--shape",
               "train_4k", "--mesh", meshes, "--smoke", "--out", str(tmp / f"group{i}")]
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True, env=_port_env()))
    one = subprocess.Popen([sys.executable, "-c", _ONE_RANK, str(tmp / "options")],
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                           env=_port_env())
    seq_parallel = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", *TRAIN_GROUPS[0][0],
         "--shape", "train_4k", "--mesh", "both", "--smoke", "--seq-parallel", "--out",
         str(tmp / "seq_parallel")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_port_env())
    try:
        from repro.optim import AdamWConfig as JaxAdamW

        jcfg = jax_smoke_config("qwen3-4b", sqrt_unit="exact", remat="none")
        case = jax_shapes.SMOKE_SHAPES["train_4k"]
        params, _ = jax_lm.init(jcfg, jax.random.key(0), abstract=True)
        opt = {"m": params, "v": params, "step": jax.ShapeDtypeStruct((), jnp.int32)}
        step = jax_steps.make_train_step(jcfg, JaxAdamW(sqrt_unit="exact"))
        text = jax.jit(step).lower(params, opt, jax_shapes.input_specs(jcfg, case)).compile()
        want = analyze_hlo(text.as_text()).flops
        outs = [p.communicate(timeout=300) for p in procs]
        one_out = one.communicate(timeout=300)
        sp_err = seq_parallel.communicate(timeout=300)[1]
    finally:
        for p in procs + [one, seq_parallel]:
            if p.poll() is None:
                p.kill()
    records = dict.fromkeys(((a, m) for a in ARCHS for m in ("single", "multi")))
    for i in range(len(TRAIN_GROUPS)):
        for path in (tmp / f"group{i}").glob("*_train_4k_*.json"):
            rec = json.loads(path.read_text())
            records[rec["arch"], rec["mesh"]] = rec
    runs = [(p.returncode, err) for p, (_, err) in zip(procs, outs)]
    assert one.returncode == 0, one_out[1][-3000:]
    options = json.loads((tmp / "options" / "qwen3-4b_train_4k_single.json").read_text())
    assert seq_parallel.returncode == 0, sp_err[-3000:]
    sp = {path.stem: json.loads(path.read_text())
          for path in (tmp / "seq_parallel").glob("*.json")}
    return records, runs, json.loads(one_out[0].strip().splitlines()[-1]), options, want, sp


@pytest.mark.parametrize("mesh,n", [("single", 4), ("multi", 8)])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_cell_runs(train_cells, arch, mesh, n):
    rec = train_cells[0][arch, mesh]
    assert rec is not None and rec["status"] == "ok", rec and rec["status"]
    assert rec["n_chips"] == n and rec["chip"] == "nvidia-h100-sxm"
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["memory"]["peak_estimate_bytes"] > 0
    # the layers' FSDP gathers and their gradients' reduce-scatters
    assert rec["collectives"]["all-gather"]["bytes"] > 0
    assert rec["collectives"]["reduce-scatter"]["bytes"] > 0
    assert rec["launches"].get("e2afs_rsqrt", 0) > 0
    assert (rec["microbatches"], rec["seq_parallel"], rec["remat"]) == (1, False, "block")


def test_cli_reference_train_cells(train_cells):
    """The reference test's train cells (qwen3-4b, mixtral-8x22b) ran in the
    first CLI group, which, like the others, exited 0 without JAX."""
    for code, err in train_cells[1]:
        assert code == 0, err[-3000:]
        assert "jax" not in err
    assert {m for (a, m), r in train_cells[0].items()
            if a in ("qwen3-4b", "mixtral-8x22b") and r["status"] == "ok"} == {"single", "multi"}


def test_train_cell_dot_flops_within_2pct_of_analyze_hlo(train_cells):
    rec, want = train_cells[2], train_cells[4]
    assert rec["n_chips"] == 1 and rec["remat"] == "none"
    assert rec["flops_per_device"] == pytest.approx(want, rel=0.02)
    assert "all-gather" not in rec["collectives"]  # a one-wide mesh splits nothing


def test_cli_train_options_recorded(train_cells):
    rec = train_cells[3]
    assert rec["status"] == "ok"
    assert (rec["microbatches"], rec["remat"], rec["seq_parallel"]) == (2, "minimal", False)


@pytest.mark.parametrize("mesh", ["single", "multi"])
@pytest.mark.parametrize("arch", TRAIN_GROUPS[0][0])
def test_cli_seq_parallel_train_cells(train_cells, arch, mesh):
    """``--seq-parallel``: the residual stream's sequence over 'model'
    between blocks, so each block's exit reduce-scatters the sequence where
    it all-reduced (more reduce-scatters, fewer all-reduces than the same
    cell without it)."""
    rec, plain = train_cells[5][f"{arch}_train_4k_{mesh}_sp"], train_cells[0][arch, mesh]
    assert rec["status"] == "ok" and rec["seq_parallel"] is True
    count = lambda r, kind: r["collectives"].get(kind, {}).get("count", 0)  # noqa: E731
    assert count(rec, "reduce-scatter") > count(plain, "reduce-scatter")
    assert count(rec, "all-reduce") < count(plain, "all-reduce")
