"""The port's kernel registry, tile tuner and chip model held against the
JAX package's (``tests/kernels/test_dispatch.py``'s TestRegistry,
TestBackendResolution and TestAutotune, and ``test_tuning_roofline.py``).

The prior's arithmetic is compared on the reference's own chip constants: a
port ``ChipModel`` built from the fields of ``repro.core.hw_model.TPU_V5E``
and ``INTERPRET_CPU``, on the same geometries, equal to
``repro.kernels.tuning``'s within 1e-12 relative.  Sweeps run on CPU
callables (host clock).  Pad helpers: equal to the reference's on the same
numpy inputs, exactly.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hw_model as jax_hw
from repro.kernels import dispatch as jax_dispatch
from repro.kernels import tuning as jax_tuning
from repro_torch.core import hw_model
from repro_torch.kernels import dispatch, tuning

TPU = hw_model.ChipModel(**dataclasses.asdict(jax_hw.TPU_V5E))
CPU_INTERP = hw_model.ChipModel(**dataclasses.asdict(jax_hw.INTERPRET_CPU))


@pytest.fixture()
def cache(tmp_path, monkeypatch):
    path = tmp_path / "kernel_tune.json"
    monkeypatch.setenv(tuning.ENV_CACHE, str(path))
    monkeypatch.delenv(tuning.ENV_AUTOTUNE, raising=False)
    dispatch.forget_choices()
    yield path
    dispatch.forget_choices()


def _rms_np(rows, width):
    return np.random.default_rng(0).normal(size=(rows, width)).astype(np.float32)


def _rms_args(rows, width):
    return (torch.from_numpy(_rms_np(rows, width)), torch.ones(width))


def _jax_rms_args(rows, width):
    return (jnp.asarray(_rms_np(rows, width)), jnp.ones((width,), jnp.float32))


# ---------------------------------------------------------------------------
# the registry and the backend
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_all_known_kernels_register(self):
        assert dispatch.registered() == tuple(sorted(set(dispatch.KNOWN)))
        assert dispatch.registered() == jax_dispatch.registered()

    def test_specs_are_complete(self):
        for name in dispatch.KNOWN:
            spec = dispatch.get(name)
            assert spec.name == name
            assert callable(spec.reference) and callable(spec.kernel)
            assert tuple(spec.tiling.default) in tuple(spec.tiling.candidates)

    def test_single_candidate_kernels(self):
        """kmeans_assign's tile sets its sums' order and decode attention's
        split the bits of replays: one candidate each (ROADMAP C)."""
        for name in ("kmeans_assign", "decode_attention"):
            assert len(dispatch.get(name).tiling.candidates) == 1

    def test_unknown_kernel_raises(self):
        with pytest.raises(ValueError, match="unknown kernel"):
            dispatch.get("fft")

    def test_default_outside_candidates_rejected(self):
        with pytest.raises(ValueError, match="not among candidates"):
            dispatch.TilingSpec(default=(7,), candidates=((8,),))

    @pytest.mark.parametrize("name", ["e2afs_sqrt", "e2afs_rsqrt", "rmsnorm", "sobel"])
    def test_dispatch_on_cpu_is_the_plain_version(self, name):
        x = torch.rand(6, 40) * 50 + 1.0
        args = {"rmsnorm": (x, torch.zeros(40) + 0.1)}.get(name, (x,))
        spec = dispatch.get(name)
        want = spec.reference(*args)
        for backend in ("auto", "reference"):
            prev = dispatch.set_backend(backend)
            try:
                got = dispatch.dispatch(name, *args)
            finally:
                dispatch.set_backend(prev)
            assert torch.equal(got, want)


@pytest.fixture()
def no_override(monkeypatch):
    """The route from the variable alone: no set_backend() in force."""
    monkeypatch.setattr(dispatch, "_backend_override", None)


@pytest.mark.usefixtures("no_override")
class TestBackendResolution:
    def test_auto_by_default(self, monkeypatch):
        monkeypatch.delenv(dispatch.ENV_BACKEND, raising=False)
        assert dispatch.resolve_backend() == "auto"

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv(dispatch.ENV_BACKEND, "reference")
        assert dispatch.resolve_backend() == "reference"
        monkeypatch.setenv(dispatch.ENV_BACKEND, "interpret")
        with pytest.raises(ValueError, match="REPRO_KERNEL_BACKEND.*'auto', 'reference'"):
            dispatch.resolve_backend()

    def test_set_backend_beats_env(self, monkeypatch):
        monkeypatch.setenv(dispatch.ENV_BACKEND, "auto")
        prev = dispatch.set_backend("reference")
        try:
            assert dispatch.resolve_backend() == "reference"
        finally:
            dispatch.set_backend(prev)

    def test_set_backend_rejects_unknown(self):
        with pytest.raises(ValueError, match="unknown backend"):
            dispatch.set_backend("cuda")

    def test_use_kernel_rule_unchanged(self, monkeypatch):
        monkeypatch.setenv(dispatch.ENV_BACKEND, "auto")
        assert not dispatch.use_kernel(torch.zeros(1))
        with pytest.raises(ValueError, match="no kernel route"):
            dispatch.use_kernel(torch.zeros(1, device="meta"))


class TestAutotune:
    def test_sweep_persists_and_cache_hits(self, cache, monkeypatch):
        spec = dispatch.get("e2afs_sqrt")
        x = torch.rand(3, 37) + 0.1
        timed = []

        def run(block):
            timed.append(tuple(block))
            return spec.reference(x)

        block = tuning.choose_block("e2afs_sqrt", spec.tiling.candidates, spec.tiling.default,
                                    run, (x,), tune=True)
        assert set(timed) == set(spec.tiling.candidates)  # no model of the CPU: the blind grid
        data = json.loads(cache.read_text())
        assert data["version"] == tuning.CACHE_VERSION
        (key, entry), = data["entries"].items()
        assert key == "e2afs_sqrt/cuda/float32/n2^7"
        assert tuple(entry["block"]) == block and entry["timings_us"]

        def boom(*a, **k):
            raise AssertionError("sweep ran on a cache hit")

        monkeypatch.setattr(tuning, "sweep", boom)
        assert tuning.choose_block("e2afs_sqrt", spec.tiling.candidates, spec.tiling.default,
                                   run, (x,), tune=True) == block

    @pytest.mark.parametrize("kind", ["fake", "meta"])
    def test_no_tuning_on_untimeable_tensors(self, cache, monkeypatch, kind):
        from torch._subclasses.fake_tensor import FakeTensorMode

        monkeypatch.setenv(tuning.ENV_AUTOTUNE, "1")
        spec = dispatch.get("rmsnorm")

        def run(block):
            raise AssertionError("a sweep timed untimeable tensors")

        if kind == "meta":
            args = (torch.empty(512, 1024, device="meta"), torch.empty(1024, device="meta"))
            block = tuning.choose_block("rmsnorm", spec.tiling.candidates, spec.tiling.default,
                                        run, args)
        else:
            with FakeTensorMode():
                args = (torch.empty(512, 1024), torch.empty(1024))
                block = tuning.choose_block("rmsnorm", spec.tiling.candidates,
                                            spec.tiling.default, run, args)
        assert block == tuple(spec.tiling.default)
        assert not cache.exists()

    def test_default_block_when_tuning_off(self, cache):
        spec = dispatch.get("rmsnorm")

        def run(block):
            raise AssertionError("swept with tuning off")

        block = tuning.choose_block("rmsnorm", spec.tiling.candidates, spec.tiling.default, run,
                                    _rms_args(5, 256))
        assert block == tuple(spec.tiling.default)

    def test_resolution_is_memoised(self, cache, monkeypatch):
        calls = []
        real = tuning.choose_block

        def counted(*a, **k):
            calls.append(a[0])
            return real(*a, **k)

        monkeypatch.setattr(tuning, "choose_block", counted)
        x, s = _rms_args(8, 256)

        def sweep_run():
            raise AssertionError("built a sweep's callable with tuning off")

        for _ in range(3):
            assert dispatch.resolve_block("rmsnorm", (x, s), sweep_run, ()) == (0,)
        assert calls == ["rmsnorm"]
        # nothing cached of rmsnorm, tuning off: every shape takes the default
        assert dispatch.resolve_block("rmsnorm", _rms_args(9, 256), sweep_run, ()) == (0,)
        assert len(calls) == 1
        dispatch.forget_choices()
        dispatch.resolve_block("rmsnorm", (x, s), sweep_run, ())
        assert len(calls) == 2
        # a cached tile of rmsnorm (another size): memoised per shape
        tuning.record(tuning.problem_key("rmsnorm", _rms_args(64, 256)), (2,), {})
        dispatch.forget_choices()
        for _ in range(2):
            assert dispatch.resolve_block("rmsnorm", (x, s), sweep_run, ()) == (0,)
            assert dispatch.resolve_block("rmsnorm", _rms_args(64, 256), sweep_run, ()) == (2,)
        assert len(calls) == 4

    def test_resolve_block_builds_the_sweep_callable_once(self, cache):
        """A sweep builds its callable once from the wrapper's arguments
        (adam's copies of p, m and v), and a memoised call builds none."""
        built, timed = [], []

        def sweep_run(tag):
            built.append(tag)
            return lambda block: timed.append(tuple(block))

        x, s = _rms_args(8, 256)
        block = dispatch.resolve_block("rmsnorm", (x, s), sweep_run, ("t",), tune=True)
        assert built == ["t"] and set(timed) == set(dispatch.get("rmsnorm").tiling.candidates)
        assert dispatch.resolve_block("rmsnorm", (x, s), sweep_run, ("t",)) == block
        assert built == ["t"]


# ---------------------------------------------------------------------------
# the cache and the roofline prior (test_tuning_roofline.py's cases)
# ---------------------------------------------------------------------------


class TestCacheRoundtrip:
    def test_record_then_lookup_through_json(self, cache):
        key = tuning.problem_key("rmsnorm", _rms_args(64, 256))
        tuning.record(key, (2,), {"[2]": 12.5})
        on_disk = json.loads(cache.read_text())
        assert on_disk["version"] == tuning.CACHE_VERSION
        assert on_disk["entries"][key]["block"] == [2]
        assert on_disk["entries"][key]["timings_us"]["[2]"] == 12.5
        tuning._mem.pop(str(cache), None)  # cold re-read from disk
        assert tuning.lookup(key, [(1,), (2,), (4,)]) == (2,)

    def test_stale_entry_invalidated_on_tilingspec_change(self, cache):
        key = tuning.problem_key("rmsnorm", _rms_args(64, 256))
        tuning.record(key, (16,), {})
        assert tuning.lookup(key, [(8,), (16,)]) == (16,)
        assert tuning.lookup(key, [(8,), (32,)]) is None

    def test_choose_block_prefers_cache_hit_over_prior(self, cache):
        args = _rms_args(512, 1024)
        tuning.record(tuning.problem_key("rmsnorm", args), (64,), {})
        block = tuning.choose_block("rmsnorm", [(8,), (64,), (512,)], (8,), lambda b: None, args,
                                    chip=CPU_INTERP)
        assert block == (64,)

    def test_corrupt_cache_tolerated(self, cache):
        cache.write_text("{not json")
        key = tuning.problem_key("rmsnorm", _rms_args(64, 256))
        assert tuning.lookup(key, [(1,)]) is None
        tuning.record(key, (1,), {})
        assert tuning.lookup(key, [(1,)]) == (1,)

    def test_unwritable_cache_tolerated(self, tmp_path, monkeypatch):
        blocker = tmp_path / "a_file"
        blocker.write_text("")
        monkeypatch.setenv(tuning.ENV_CACHE, str(blocker / "tune.json"))  # parent is a file
        key = tuning.problem_key("rmsnorm", _rms_args(64, 256))
        tuning.record(key, (2,), {})  # nothing persisted, no raise
        assert tuning.lookup(key, [(2,)]) == (2,)  # the in-memory pick stands


class TestRooflinePrior:
    def test_occupancy_floor_rejects_overhead_bound_tiles(self):
        geom = tuning.tile_geometry(_rms_args(512, 1024))
        _, occ_small, _ = tuning.predict_block_time((8,), geom, CPU_INTERP)
        _, occ_big, _ = tuning.predict_block_time((512,), geom, CPU_INTERP)
        assert occ_small < tuning.OCC_FLOOR < occ_big

    def test_plan_narrows_to_admissible(self):
        spec = jax_dispatch.get("rmsnorm")
        prior, admissible = tuning.roofline_plan(spec.tiling.candidates, spec.tiling.default,
                                                 _rms_args(512, 1024), chip=CPU_INTERP)
        assert len(admissible) < len(spec.tiling.candidates)
        assert prior in admissible
        assert all(c in tuple(tuple(x) for x in spec.tiling.candidates) for c in admissible)

    def test_tiny_input_keeps_tilingspec_default(self):
        spec = jax_dispatch.get("rmsnorm")
        prior, admissible = tuning.roofline_plan(spec.tiling.candidates, spec.tiling.default,
                                                 _rms_args(5, 256), chip=CPU_INTERP)
        assert prior == tuple(spec.tiling.default)
        assert len(admissible) <= tuning._NARROW_TOP

    def test_modeling_failure_falls_back_to_blind_grid(self):
        prior, admissible = tuning.roofline_plan([(8,), (16,)], (8,), ("not", "tensors"),
                                                 chip=CPU_INTERP)
        assert prior == (8,) and admissible == ((8,), (16,))
        # no chip model for the CPU: the same fallback
        prior, admissible = tuning.roofline_plan([(8,), (16,)], (8,), _rms_args(4, 8))
        assert prior == (8,) and admissible == ((8,), (16,))

    def test_rmsnorm_pick_no_longer_block_8(self, cache):
        """The reference's case on its rmsnorm spec: the roofline's pick.  The
        port's untuned ``choose_block`` takes the default, so the pick is
        read from ``roofline_plan``, which narrows the port's sweeps."""
        spec = jax_dispatch.get("rmsnorm")
        block, _ = tuning.roofline_plan(spec.tiling.candidates, spec.tiling.default,
                                        _rms_args(512, 1024), chip=CPU_INTERP)
        assert block != (8,) and block[0] >= 128
        assert tuning.choose_block("rmsnorm", spec.tiling.candidates, spec.tiling.default,
                                   lambda b: None, _rms_args(512, 1024),
                                   chip=CPU_INTERP) == (8,)


class TestSweepNarrowing:
    def test_sweep_only_times_admissible_candidates(self, cache):
        spec = jax_dispatch.get("rmsnorm")
        args = _rms_args(512, 1024)
        _, admissible = tuning.roofline_plan(spec.tiling.candidates, spec.tiling.default, args,
                                             chip=CPU_INTERP)
        timed = []

        def run(block):
            timed.append(tuple(block))
            return torch.zeros(())

        block = tuning.choose_block("rmsnorm", spec.tiling.candidates, spec.tiling.default, run,
                                    args, tune=True, chip=CPU_INTERP)
        assert set(timed) == set(admissible) and block in admissible
        assert tuning.lookup(tuning.problem_key("rmsnorm", args), spec.tiling.candidates) == block

    def test_sweep_failure_falls_back_to_prior(self, cache):
        """The reference falls back to its prior; the port to the default,
        the launch an untuned call takes."""
        spec = jax_dispatch.get("rmsnorm")
        args = _rms_args(512, 1024)

        def boom(block):
            raise RuntimeError("no backend")

        block = tuning.choose_block("rmsnorm", spec.tiling.candidates, spec.tiling.default, boom,
                                    args, tune=True, chip=CPU_INTERP)
        assert block == tuple(spec.tiling.default)
        if cache.exists():
            assert not json.loads(cache.read_text())["entries"]


# ---------------------------------------------------------------------------
# the arithmetic against the reference's, on the reference's chips
# ---------------------------------------------------------------------------

_GEOMETRY_CASES = [(512, 1024), (5, 256), (64, 2560), (1, 7), (4096, 128)]


@pytest.mark.parametrize("interpret,chip", [(False, TPU), (True, CPU_INTERP)])
@pytest.mark.parametrize("rows,width", _GEOMETRY_CASES)
def test_prior_arithmetic_equals_reference(interpret, chip, rows, width):
    geom = tuning.tile_geometry(_rms_args(rows, width))
    assert geom == jax_tuning.tile_geometry(_jax_rms_args(rows, width))
    ref_chip = jax_hw.chip_for_backend(interpret)
    for name in ("rmsnorm", "e2afs_sqrt", "adam", "sobel"):
        for cand in jax_dispatch.get(name).tiling.candidates:
            got = tuning.predict_block_time(cand, geom, chip)
            want = jax_tuning.predict_block_time(cand, geom, ref_chip)
            np.testing.assert_allclose(got[:2], want[:2], rtol=1e-12, atol=0)
            assert got[2] == want[2]
        spec = jax_dispatch.get(name).tiling
        got = tuning.roofline_plan(spec.candidates, spec.default, _rms_args(rows, width),
                                   chip=chip)
        want = jax_tuning.roofline_plan(spec.candidates, spec.default,
                                        _jax_rms_args(rows, width), interpret=interpret)
        assert got == want


@pytest.mark.parametrize("interpret,chip", [(False, TPU), (True, CPU_INTERP)])
def test_capped_geometry_equals_reference(interpret, chip):
    """A geometry with a tile cap (the kmeans kind) gives the reference's
    plan on the same dict."""
    spec = jax_dispatch.get("kmeans_assign").tiling
    geom = spec.geometry((jnp.zeros((2048, 3)), jnp.zeros((5, 3))))
    got = tuning.roofline_plan(spec.candidates, spec.default, (torch.zeros(1),), chip=chip,
                               geometry=lambda args: geom)
    want = jax_tuning.roofline_plan(spec.candidates, spec.default, (jnp.zeros(1),),
                                    interpret=interpret, geometry=lambda args: geom)
    assert got == want


# ---------------------------------------------------------------------------
# the H100 model and the port's tiles at the main path's shapes
# ---------------------------------------------------------------------------


def test_chip_model_fields_are_the_reference_s():
    assert ([f.name for f in dataclasses.fields(hw_model.ChipModel)]
            == [f.name for f in dataclasses.fields(jax_hw.ChipModel)])
    assert hw_model.H100_SXM.peak_flops == 989.4e12 and hw_model.H100_SXM.hbm_bw == 3.35e12
    assert hw_model.H100_SXM.vmem_bytes == 232_448


def test_chip_for_device_refuses_the_cpu():
    with pytest.raises(ValueError, match="no chip model"):
        hw_model.chip_for_device("cpu")


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


# (kernel, its operands at a main-path shape of chip_smoke.py, today's launch;
# RMSNorm's (0,) is the rows a group csrc/rmsnorm.cu chooses itself)
_MAIN_PATH = [
    ("e2afs_rsqrt", (_meta((8, 512, 2560)),), (256, 4)),  # phase 4b's unit path
    ("e2afs_rsqrt", (_meta((4, 2048, 1)),), (256, 4)),  # phase 11's unfused norms
    ("e2afs_rsqrt", (_meta((8, 1, 1)),), (256, 4)),  # a decode step's LayerNorm
    ("rmsnorm", (_meta((8, 1, 2560), torch.bfloat16), _meta((2560,), torch.bfloat16)), (0,)),
    ("rmsnorm", (_meta((8, 1, 32, 128), torch.bfloat16), _meta((128,), torch.bfloat16)), (0,)),
    ("rmsnorm", (_meta((8, 512, 32, 128), torch.bfloat16), _meta((128,), torch.bfloat16)), (0,)),
    ("rmsnorm", (_meta((8, 512, 2560), torch.bfloat16), _meta((2560,), torch.bfloat16)), (0,)),
    ("sobel", (_meta((2160, 3840)),), (4, 128)),
    ("sobel", (_meta((256, 256)),), (4, 128)),
    ("adam", (_meta((2560, 9728)),) * 4 + (_meta((3,)),), (256, 8)),
    ("adam", (_meta((128,)),) * 4 + (_meta((3,)),), (256, 8)),
]


@pytest.mark.parametrize("name,args,today", _MAIN_PATH)
def test_h100_prior_picks_today_s_launch(cache, monkeypatch, name, args, today):
    """With nothing cached, an untuned pick at a main-path shape is today's
    launch, tuning on or off (meta operands cannot be timed); the H100
    roofline keeps today's launch among the tiles a sweep times."""
    spec = dispatch.get(name).tiling

    def run(block):
        raise AssertionError("a sweep timed meta tensors")

    for autotune in ("0", "1"):
        monkeypatch.setenv(tuning.ENV_AUTOTUNE, autotune)
        assert tuning.choose_block(name, spec.candidates, spec.default, run, args,
                                   geometry=spec.geometry) == today == tuple(spec.default)
    _, admissible = tuning.roofline_plan(spec.candidates, spec.default, args,
                                         chip=hw_model.H100_SXM, geometry=spec.geometry)
    assert today in admissible


# ---------------------------------------------------------------------------
# the pad helpers against the reference's
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,width,block_rows,pad", [(37, 8, 2, 1.0), (64, 8, 4, 0.0),
                                                    (1, 16, 3, 0.0), (0, 4, 2, 1.0)])
def test_as_blocked_2d_and_unblock_equal_reference(n, width, block_rows, pad):
    x = np.arange(n, dtype=np.float32).reshape(-1) + 0.5
    got = dispatch.as_blocked_2d(torch.from_numpy(x), width=width, block_rows=block_rows,
                                 pad_value=pad)
    want = jax_dispatch.as_blocked_2d(jnp.asarray(x), width=width, block_rows=block_rows,
                                      pad_value=pad)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dispatch.unblock(got, n, x.shape).numpy(),
                                  np.asarray(jax_dispatch.unblock(want, n, x.shape)))


def test_as_blocked_2d_returns_aligned_input():
    x = torch.ones(8, 16)
    assert dispatch.as_blocked_2d(x, width=16, block_rows=4) is x


@pytest.mark.parametrize("rows,block_rows", [(5, 4), (8, 4), (1, 8)])
def test_pad_rows_equals_reference(rows, block_rows):
    x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
    got = dispatch.pad_rows(torch.from_numpy(x), block_rows, pad_value=2.0)
    want = jax_dispatch.pad_rows(jnp.asarray(x), block_rows, pad_value=2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape,block,halo", [((3, 4), (4, 4), 2), ((66, 130), (64, 128), 2),
                                              ((2, 5, 7), (4, 8), 0), ((67, 93), (32, 128), 2)])
def test_pad2d_to_multiple_equals_reference(shape, block, halo):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    got = dispatch.pad2d_to_multiple(torch.from_numpy(x), block, halo=halo)
    want = jax_dispatch.pad2d_to_multiple(jnp.asarray(x), block, halo=halo)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if got.shape == x.shape:
        t = torch.from_numpy(x)
        assert dispatch.pad2d_to_multiple(t, block, halo=halo) is t
