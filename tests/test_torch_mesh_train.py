"""The port's sharded train step (``train_rules``: FSDP over 'data' x TP
over 'model' x EP) held against the unsharded port step and the JAX
package's ``make_train_step``.

The ranks run in ONE spawned world of 4 gloo ranks on a (data=2, model=2)
mesh, shared by the module (``world``), as ``tests/test_torch_mesh.py``
runs its own: one torch thread a rank, a ``file://`` rendezvous under the
test's temporary directory, no JAX in the ranks.  Each rank places a smoke
model (float32 activations, the e2afs unit, fused AdamW on its plain
version, the clip at 1.0) with ``sharding.place_train_state``, takes its
rows of the batch, and runs the loss's backward and one train step inside
the mesh scope; it gathers the gradients and the updated params, m and v
(``sharding.gather_train_state``).  Rank 0 pickles the whole tensors, every
rank a digest of its gathered tensors.  The parent runs the same steps
unsharded, and a spawned helper the JAX package's train step, meanwhile.

Cases: each LM family's smoke config; mixtral-8x22b with 3 experts, which
a 2-wide 'model' axis does not divide (experts replicated, their hidden
units over 'model'); qwen3-4b with ``microbatches=2`` against one
microbatch (a mask of ones: the step averages the microbatches' losses,
which equals the whole batch's when the counts are equal); qwen3-4b and
mixtral-8x22b with ``microbatches=2`` and the random mask against the
unsharded step's two microbatches (each microbatch's loss is its own
rows' NLL over their count, and the MoE aux a product of means over
them: the rank's rows are laid out by ``sharding.place_batch``).  A second
world of 4 ranks, run beside the first, takes each family and the
3-expert mixtral again under ``train_rules(seq_parallel=True)`` (the
residual stream's sequence over 'model' between blocks), held to the same
unsharded steps.

The step is AdamW at lr 1e-3 with one warm-up step, so the first update
moves each parameter by about lr.  Tolerances, each against the unsharded
port step (the 'model' axis's partial sums and the data axes' gradient
sums reassociate): the loss and the MoE aux within 1e-5 x max(1,
|value|); every gathered gradient leaf within 1e-5 x max(1, max |g|);
after one step, m and v within 1e-5 x max |leaf| of each leaf (m is the
clipped gradient over ten, v its square over twenty).  The parameters'
update is held, within 1e-4 x lr, to the AdamW update of the sharded
step's own m and v from the shared start, computed here in the plain
``adam`` kernel's order: the first update is ``g / (|g| + eps)`` through
the e2afs sqrt, which a reassociated sum moves by up to 2 x lr where the
gradient is near eps and by the unit's step (3.7 or 7.1 % of lr) where
``v`` sits at one of its discontinuities (ROADMAP C.47), so it is not
held to the reference's update itself.  The same for qwen3-4b against the
JAX package's step (its unfused AdamW, the port's fused update's plain
version).  Every rank's gathered state is identical.
"""
import dataclasses
import hashlib
import os
import pickle
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.configs.shapes import ShapeCase, input_specs
from repro_torch.launch import steps
from repro_torch.models import convert, lm
from repro_torch.core import get_unit
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.optim.adamw import bias_corrections, cosine_lr

LM_IDS = tuple(a for a in ARCH_IDS if a != "e2afs-fp16")
WORLD = 4
B, S = 4, 16
OPT = dict(sqrt_unit="e2afs", fused=True, lr=1e-3, warmup_steps=1)
TOL = 1e-5
# the parameters' update against the AdamW of the step's own moments, over lr
UPDATE_TOL = 1e-4
# (key, arch, experts override, microbatches, mask of ones, sequence
# parallel, the unsharded reference's microbatches)
CASES = tuple((a, a, None, 1, False, False, 1) for a in LM_IDS) + (
    ("mixtral-8x22b/experts=3", "mixtral-8x22b", 3, 1, False, False, 1),
    ("qwen3-4b/microbatches=2", "qwen3-4b", None, 2, True, False, 1),
    ("qwen3-4b/microbatches=2/mask", "qwen3-4b", None, 2, False, False, 2),
    ("mixtral-8x22b/microbatches=2/mask", "mixtral-8x22b", None, 2, False, False, 2),
)
# the same under train_rules(seq_parallel=True), held to the same unsharded
# steps (the key's part before "/sp"); a second world runs them beside the
# first
SP_CASES = tuple((f"{a}/sp", a, None, 1, False, True, 1) for a in LM_IDS) + (
    ("mixtral-8x22b/experts=3/sp", "mixtral-8x22b", 3, 1, False, True, 1),
)


def _config(arch, experts=None):
    cfg = get_smoke_config(arch, sqrt_unit="e2afs", act_dtype="float32")
    if experts is not None:
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, n_experts=experts)).validate()
    return cfg


def _model(cfg):
    """The smoke model from seed 0 as float32 masters, its constant starts
    moved (a fresh RG-LRU computes nothing)."""
    model = lm.init(cfg, torch.Generator().manual_seed(0), device="cpu", trainable=True)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _, p in lm.constant_start_parameters(model):
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def _batch(cfg, ones=False) -> dict:
    """The whole batch (B rows) from seed 2: tokens, labels, a loss mask,
    and the vision stub's or the encoder's inputs where the config has
    them."""
    gen = torch.Generator().manual_seed(2)
    out = {}
    for name, spec in input_specs(cfg, ShapeCase("train", S, B, "train")).items():
        if name in ("tokens", "labels"):
            out[name] = torch.randint(0, cfg.vocab, tuple(spec.shape), generator=gen,
                                      dtype=torch.int32)
        elif name == "loss_mask":
            out[name] = (torch.ones(tuple(spec.shape)) if ones else
                         (torch.rand(tuple(spec.shape), generator=gen) < 0.9).float())
        else:
            out[name] = torch.randn(tuple(spec.shape), generator=gen)
    return out


def _steps(cfg, model, opt, batch, microbatches, mesh=None, rules=None):
    """(loss metrics, gradients by name) of the loss's backward, then one
    train step: (metrics, grads, step metrics).  Off a mesh the gradients
    are the model's own; on one, the rank's blocks."""
    from repro_torch.distributed.constraints import maybe_axis_rules

    with maybe_axis_rules(mesh, rules):
        total, metrics = steps.loss_fn(model, cfg, batch)
        total.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    step = steps.make_train_step(cfg, AdamWConfig(**OPT), microbatches=microbatches, mesh=mesh,
                                 rules=rules)
    _, opt, out = step(model, opt, batch)
    metrics = {"total": float(total.detach()), "loss": float(metrics["loss"].detach()),
               "moe_aux": float(metrics["moe_aux"].detach())}
    return metrics, grads, {k: float(v) for k, v in out.items()}, opt


def _numpy(named: dict) -> dict:
    return {n: t.detach().numpy().copy() for n, t in named.items()}


def _digest(*trees) -> str:
    h = hashlib.sha256()
    for tree in trees:
        for n in sorted(tree):
            h.update(n.encode())
            h.update(np.ascontiguousarray(tree[n]).tobytes())
    return h.hexdigest()


def _rank_case(mesh, rank, arch, experts, microbatches, ones, sp, _) -> dict:
    from repro_torch.distributed import sharding

    cfg = _config(arch, experts)
    rules = sharding.train_rules(cfg, mesh, seq_parallel=sp)
    model, opt = sharding.place_train_state(_model(cfg), cfg, mesh, rules)
    rows = sharding.place_batch(_batch(cfg, ones), mesh, rules, microbatches)
    metrics, grads, step, opt = _steps(cfg, model, opt, rows, microbatches, mesh, rules)
    grads = _numpy({n: sharding.gather(g, model.placement[n]) for n, g in grads.items()})
    state = sharding.gather_train_state(model, opt)
    state = {k: _numpy(state[k]) for k in ("params", "m", "v")}
    out = {"metrics": metrics, "step": step,
           "digest": _digest(grads, state["params"], state["m"], state["v"])}
    if rank == 0:
        out.update(grads=grads, **state)
    return out


def _rank_main(rank: int, init_file: str, tmp: str, cases: str) -> None:
    """One rank: one torch thread, gloo through a file rendezvous, every
    case of ``CASES`` or ``SP_CASES``, its results pickled to
    ``<cases>_rank<r>.pkl``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_production_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=WORLD)
    try:
        t0 = time.perf_counter()
        mesh = make_production_mesh(shape=(2, 2), device="cpu")
        out = {key: _rank_case(mesh, rank, *case)
               for key, *case in {"CASES": CASES, "SP_CASES": SP_CASES}[cases]}
        out["seconds"] = time.perf_counter() - t0
        with open(os.path.join(tmp, f"{cases}_rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def _unsharded(arch, experts, microbatches, ones) -> dict:
    cfg = _config(arch, experts)
    model = _model(cfg)
    start = _numpy(dict(model.named_parameters()))
    opt = adamw_init(model)
    metrics, grads, step, opt = _steps(cfg, model, opt, _batch(cfg, ones), microbatches)
    return {"metrics": metrics, "step": step, "grads": _numpy(grads), "start": start,
            "params": _numpy(dict(model.named_parameters())), "m": _numpy(opt["m"]),
            "v": _numpy(opt["v"])}


def _jax_main(tmp: str) -> None:
    """The JAX package's loss, gradients and train step (unfused AdamW) on
    the port's qwen3-4b smoke weights and batch, as trees, in a process
    beside the parent's, pickled to ``jax.pkl``."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke
    from repro.launch import steps as jax_steps
    from repro.optim import AdamWConfig as JaxAdamW
    from repro.optim import adamw_init as jax_adamw_init

    cfg = _config("qwen3-4b")
    jcfg = jax_smoke("qwen3-4b", sqrt_unit="e2afs", act_dtype="float32")
    params = jax.tree.map(jnp.asarray, convert.params_to_numpy(_model(cfg)))
    batch = {k: jnp.asarray(v.numpy()) for k, v in _batch(cfg).items()}
    (total, metrics), grads = jax.jit(jax.value_and_grad(jax_steps.loss_fn, has_aux=True),
                                      static_argnums=1)(params, jcfg, batch)
    opt_cfg = JaxAdamW(**{k: v for k, v in OPT.items() if k != "fused"})
    new, opt, step = jax.jit(jax_steps.make_train_step(jcfg, opt_cfg))(
        params, jax_adamw_init(params), batch)
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = {"metrics": {"total": float(total), "loss": float(metrics["loss"])},
           "step": {k: float(v) for k, v in step.items()}, "grads": tree(grads),
           "params": tree(new), "m": tree(opt["m"]), "v": tree(opt["v"])}
    with open(os.path.join(tmp, "jax.pkl"), "wb") as f:
        pickle.dump(out, f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The two 4-rank worlds' results (one dict a rank, the cases of both)
    beside the parent's unsharded references and a helper process's JAX
    reference, computed while the ranks run."""
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("mesh_train_world")
    t0 = time.perf_counter()
    worlds = [mp.start_processes(_rank_main, args=(str(tmp / f"rendezvous_{cases}"), str(tmp),
                                                   cases),
                                 nprocs=WORLD, join=False, start_method="spawn")
              for cases in ("CASES", "SP_CASES")]
    helper = mp.get_context("spawn").Process(target=_jax_main, args=(str(tmp),))
    helper.start()
    try:
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            ref = {key: _unsharded(arch, experts, ref_micro, ones)
                   for key, arch, experts, _, ones, _, ref_micro in CASES}
        finally:
            torch.set_num_threads(threads)
        ref["seconds"] = time.perf_counter() - t0
        helper.join(timeout=max(1.0, 240 - (time.perf_counter() - t0)))
        if helper.exitcode != 0:
            raise RuntimeError(f"the JAX helper process ended with {helper.exitcode}")
        for ctx in worlds:
            while not ctx.join(timeout=0.5):
                if time.perf_counter() - t0 > 240:
                    raise TimeoutError("a 4-rank world did not finish in 240 s")
    finally:
        for p in [p for ctx in worlds for p in ctx.processes] + [helper]:
            if p.is_alive():
                p.terminate()
    with open(tmp / "jax.pkl", "rb") as f:
        ref["jax"] = pickle.load(f)
    ranks = []
    for r in range(WORLD):
        out = {}
        for cases in ("CASES", "SP_CASES"):
            with open(tmp / f"{cases}_rank{r}.pkl", "rb") as f:
                part = pickle.load(f)
            out[f"seconds/{cases}"] = part.pop("seconds")
            out.update(part)
        ranks.append(out)
    return ranks, ref


def _worst(got: dict, want: dict, floor: float = 1.0) -> tuple:
    """(the largest error over max(floor, max |want|), its leaf) over the
    leaves of two {name: array} dicts of the same names; with ``floor`` 0 a
    leaf that is zero in ``want`` must be zero in ``got``."""
    assert set(got) == set(want)
    worst = (0.0, None)
    for n, w in want.items():
        assert got[n].shape == w.shape, n
        if not w.size:
            continue
        diff, top = float(np.abs(got[n] - w).max()), max(floor, float(np.abs(w).max()))
        worst = max(worst, (diff / top if top else 0.0 if diff == 0 else np.inf, n))
    return worst


def _adamw_of_moments(start: dict, m: dict, v: dict) -> dict:
    """The parameters after AdamW's first step from ``start`` with the
    moments ``m`` and ``v`` it left ({name: array}), in the plain ``adam``
    kernel's order (``kernels/adam/ref.py``)."""
    opt = AdamWConfig(**OPT)
    step = torch.ones((), dtype=torch.int32)
    lr, (b1c, b2c) = cosine_lr(opt, step), bias_corrections(opt, step)
    unit = get_unit(opt.sqrt_unit)
    out = {}
    for n, p in start.items():
        p32, mt, vt = (torch.from_numpy(a) for a in (p, m[n], v[n]))
        denom = unit.sqrt(vt / b2c) + opt.eps
        out[n] = (p32 - lr * ((mt / b1c) / denom + opt.weight_decay * p32)).numpy()
    return out


def _scalar_close(got: float, want: float) -> bool:
    return abs(got - want) <= TOL * max(1.0, abs(want))


def _check_state(key: str, got: dict, want: dict, start: dict) -> None:
    """The parameters, m and v after one step, each {name: array}, against
    the reference's (see the module docstring); ``start`` the parameters
    before it."""
    lr = AdamWConfig(**OPT).lr
    for part in ("m", "v"):
        err, leaf = _worst(got[part], want[part], floor=0.0)
        print(f"{key}: {part} after one step worst {err:.3g} of its leaf's max at {leaf}")
        assert err <= TOL, (part, leaf, err)
    expected = _adamw_of_moments(start, got["m"], got["v"])
    err, leaf = max((float(np.abs(got["params"][n] - e).max()) / lr, n)
                    for n, e in expected.items() if e.size)
    print(f"{key}: update worst {err:.3g} x lr off the AdamW of its moments at {leaf}")
    assert err <= UPDATE_TOL, ("params", leaf, err)


def test_world_ran(world):
    ranks, ref = world
    print(f"mesh train worlds: ranks {[round(r['seconds/CASES'], 1) for r in ranks]} s, "
          f"sequence parallel {[round(r['seconds/SP_CASES'], 1) for r in ranks]} s, parent "
          f"{ref['seconds']:.1f} s")
    assert len(ranks) == WORLD


@pytest.mark.parametrize("key", [c[0] for c in CASES + SP_CASES])
def test_sharded_step_matches_the_unsharded_port_step(world, key):
    ranks, ref = world
    got, want = ranks[0][key], ref[key.removesuffix("/sp")]
    for name in ("total", "loss", "moe_aux"):
        assert _scalar_close(got["metrics"][name], want["metrics"][name]), (
            name, got["metrics"][name], want["metrics"][name])
    for name in ("loss", "grad_norm"):
        assert _scalar_close(got["step"][name], want["step"][name]), (
            name, got["step"][name], want["step"][name])
    err, leaf = _worst(got["grads"], want["grads"])
    print(f"{key}: gradients worst {err:.3g} at {leaf}")
    assert err <= TOL, (leaf, err)
    _check_state(key, got, want, want["start"])


def test_every_rank_gathers_the_same_state(world):
    ranks, _ = world
    for key, *_ in CASES + SP_CASES:
        assert len({r[key]["digest"] for r in ranks}) == 1, key
        assert len({tuple(sorted(r[key]["step"].items())) for r in ranks}) == 1, key


def test_sharded_step_matches_the_jax_train_step(world):
    import jax

    ranks, ref = world
    got, want = ranks[0]["qwen3-4b"], ref["jax"]
    for name in ("total", "loss"):
        assert _scalar_close(got["metrics"][name], want["metrics"][name])
    for name in ("loss", "grad_norm"):
        assert _scalar_close(got["step"][name], want["step"][name]), name
    # the JAX trees as the port's leaves; every element of them is one
    named = {part: convert.tree_to_named(want[part], got[part]) for part in want
             if part in ("grads", "params", "m", "v")}
    for part, tree in named.items():
        assert (sum(a.size for a in tree.values())
                == sum(np.asarray(a).size for a in jax.tree.leaves(want[part]))), part
    err, leaf = _worst(got["grads"], named["grads"])
    assert err <= TOL, ("grads", leaf, err)
    _check_state("qwen3-4b vs the JAX step", got, named, ref["qwen3-4b"]["start"])
