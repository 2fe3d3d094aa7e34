"""The render across processes (`parallel.distributed`) on the CPU: two gloo
ranks, spawned once per group of cases, each with its own Engine of the
same scene.  Under fixed_rng rank 0's image and the global wave counts are
byte-equal to render()'s (unlit, lit, spp 2 float, the debug buffers);
under live RNG bitwise equal to the port's `render_sharded(n_devices=2)`
and to the JAX package's `render_sharded` on a 2-device mesh (unlit and
streamed); `trace_rays_distributed` equals both packages'
`trace_rays_sharded`.  Ranks whose Engines differ raise on both ranks,
within the deadline."""

import pickle
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from rust_raytrace_tpu.camera import camera_rays as jcamera_rays
from rust_raytrace_tpu.engine import Engine as JEngine
from rust_raytrace_tpu.models import circles as jcircles
from rust_raytrace_tpu.parallel import sharding as jsharding
from rust_raytrace_tpu.render import upload_scene as jupload_scene
from rust_raytrace_tpu_torch.engine import Engine, pick_tile
from rust_raytrace_tpu_torch.parallel import distributed
from rust_raytrace_tpu_torch.parallel.sharding import (make_mesh,
                                                       trace_rays_sharded)
from rust_raytrace_tpu_torch.render import upload_scene
from rust_raytrace_tpu_torch.utils.rng import prng_key
from test_torch_engine_args import carry
from test_torch_sharding import JAX, LIVE, RB, _circles, _sphere, _view

import distributed_cases

#: seconds a spawn of the ranks may take, rendezvous and renders included
DEADLINE = 60.0
N = 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(fn, args, tmp) -> list:
    """fn's ranks through `distributed.spawn` (a file:// rendezvous of its
    own, so that concurrent runs never meet), within DEADLINE; returns what
    each rank wrote to tmp."""
    distributed.spawn(fn, N, args=(*args, str(tmp)), timeout=DEADLINE)
    out = []
    for r in range(N):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


#: fixed_rng paths: (scene, view, Engine kwargs, render kwargs)
FIXED = {
    "unlit": lambda: (*_circles(), {}),
    "lit": lambda: (_circles(lit=True)[0], _circles()[1], {}),
    "spp2_float": lambda: (*_circles(spp=2), dict(quantize=False)),
    "debug": lambda: (*_circles(), dict(debug=True)),
}


def _live_jax(path):
    if path == "unlit":
        return jcircles.build(resolution=(48, 27), maxdepth=5)
    return _sphere(JAX, (40, 40)), _view()


def _references(cases: dict) -> dict:
    """The single controller's results of each case: render() under
    fixed_rng; the port's and the JAX package's render_sharded and
    trace_rays_sharded over N shards under live RNG."""
    refs = {}
    for name, c in cases.items():
        if name.startswith("fixed/"):
            refs[name] = Engine(c["scene"], device="cpu",
                                **c["engine"]).render(c["view"], **c["render"])
        elif name.startswith("live/"):
            refs[name] = (
                Engine(c["scene"], device="cpu", **c["engine"]).render_sharded(
                    c["view"], n_devices=N, **c["render"]),
                JEngine(c["jscene"], interpret=True,
                        **c["engine"]).render_sharded(
                    c["view"], mesh=jsharding.make_mesh(N),
                    key=jax.random.PRNGKey(5), quantize=False))
        else:
            st = upload_scene(c["scene"], page_size=c["page_size"],
                              device="cpu")
            mesh = jsharding.make_mesh(N)
            refs[name] = (
                trace_rays_sharded(st, torch.from_numpy(c["o"]),
                                   torch.from_numpy(c["d"]), c["key"],
                                   make_mesh(N, ["cpu"]), **c["trace"]),
                jsharding.trace_rays_sharded(
                    jupload_scene(c["jscene"], page_size=c["page_size"]),
                    *jsharding.shard_rays(jnp.asarray(c["o"]),
                                          jnp.asarray(c["d"]), mesh),
                    jax.random.PRNGKey(3), mesh, backend="xla", **c["trace"]))
    return refs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks over every agreeing case, while this process
    computes the references: (rank 0's results, rank 1's, references)."""
    cases = {}
    for path, make in FIXED.items():
        scene, vp, kw = make()
        cases[f"fixed/{path}"] = dict(
            kind="render", scene=scene, view=vp, engine=dict(ray_chunk=RB),
            render=dict(fixed_rng=True, **kw))
    for path, kw in LIVE.items():
        jscene, vp = _live_jax(path)
        cases[f"live/{path}"] = dict(
            kind="render", scene=carry(jscene), view=vp, engine=kw,
            render=dict(key=prng_key(5), quantize=False), jscene=jscene)
    jscene = _sphere(JAX, (8, 12))
    o, d = jcamera_rays(_view(maxdepth=3))
    cases["trace"] = dict(
        kind="trace", scene=carry(jscene), page_size=64,
        o=np.asarray(o), d=np.asarray(d), key=prng_key(3),
        trace=dict(maxdepth=3, ray_chunk=128), jscene=jscene)
    sent = {k: {f: v for f, v in c.items() if f != "jscene"}
            for k, c in cases.items()}
    got = {}

    def ranks():
        try:
            got["ranks"] = _run(distributed_cases.run_cases, (sent,),
                                tmp_path_factory.mktemp("ranks"))
        except Exception as e:      # re-raised below, in the test's thread
            got["error"] = e

    thread = threading.Thread(target=ranks)
    thread.start()
    refs = _references(cases)
    thread.join()
    if "error" in got:
        raise got["error"]
    return (*got["ranks"], refs)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _same_render(got, want):
    np.testing.assert_array_equal(_bits(got.image), _bits(want.image))
    np.testing.assert_array_equal(got.wave_rays, want.wave_rays)
    assert got.rays_traced == int(np.sum(want.wave_rays))


@pytest.mark.parametrize("path", list(FIXED))
def test_fixed_rng_equals_render(runs, path):
    r0, _, refs = runs
    mine, one = r0[f"fixed/{path}"], refs[f"fixed/{path}"]
    assert mine.image.dtype == one.image.dtype
    _same_render(mine, one)
    if path == "debug":
        np.testing.assert_array_equal(_bits(mine.primary_t),
                                      _bits(one.primary_t))
        np.testing.assert_array_equal(mine.primary_id, one.primary_id)
        assert (mine.primary_id != 0).any() and (mine.primary_id == 0).any()


@pytest.mark.parametrize("path", list(LIVE))
def test_live_equals_render_sharded_and_jax(runs, path):
    """Key 5: rank r renders shard r under fold_in(key, r), its scatter
    keyed on its own compacted layout, as the single controller's shard r
    and the JAX mesh's device r do."""
    r0, _, refs = runs
    port, ref = refs[f"live/{path}"]
    _same_render(r0[f"live/{path}"], port)
    _same_render(r0[f"live/{path}"], ref)


def test_trace_rays_distributed_equals_sharded_and_jax(runs):
    r0, r1, refs = runs
    colors, waves = r0["trace"]
    # every rank holds the gathered colors and the summed counts
    np.testing.assert_array_equal(_bits(r1["trace"][0]), _bits(colors))
    np.testing.assert_array_equal(r1["trace"][1], waves)
    (port_c, port_w), (ref_c, ref_w) = refs["trace"]
    np.testing.assert_array_equal(_bits(colors), _bits(port_c.numpy()))
    np.testing.assert_array_equal(waves, port_w.numpy())
    np.testing.assert_array_equal(_bits(colors), _bits(ref_c))
    np.testing.assert_array_equal(waves, np.asarray(ref_w))


@pytest.mark.parametrize("case", ["fixed/unlit", "fixed/debug",
                                  "live/streamed"])
def test_other_ranks_return_the_counts_and_no_image(runs, case):
    r0, r1, _ = runs
    assert r1[case].image is None and r1[case].primary_t is None
    np.testing.assert_array_equal(r1[case].wave_rays, r0[case].wave_rays)
    assert r1[case].rays_traced == r0[case].rays_traced


@pytest.mark.parametrize("spp", [1, 2])
@pytest.mark.parametrize("n", [2, 3])
def test_shard_rays_equal_the_slice_of_the_full_rays(spp, n):
    """Each rank's rays from q_base are render_sharded's slice of the full
    rays, bitwise (spp 2 jitters by position under live key 7), and alive0
    marks the lanes inside the image."""
    scene, vp = _circles(spp=spp)
    eng = Engine(scene, ray_chunk=RB, device="cpu")
    key = prng_key(7)
    R = None
    for r in range(n):
        R, o, d, alive0, pk0 = distributed.shard_rays(eng, vp, key, r, n)
        if r == 0:
            fo, fd, _, fpk0 = eng._camera_rays(
                vp, pick_tile(vp.width, vp.height), R, key)
            R0 = vp.width * vp.height * spp
        Rs = R // n
        sl = slice(r * Rs, (r + 1) * Rs)
        assert torch.equal(o.view(torch.int32), fo[:, sl].view(torch.int32))
        assert torch.equal(d.view(torch.int32), fd[:, sl].view(torch.int32))
        assert torch.equal(alive0, torch.arange(R)[sl] < R0)
        assert pk0 is fpk0
    assert R % (n * eng._quantum(spp)) == 0 and R >= R0


def test_mismatched_engines_raise_on_every_rank(tmp_path):
    """Rank 0's Engine compacts after waves 0 and 1, rank 1's never: both
    raise, naming ncompact, and neither waits in a collective."""
    scene, vp = _circles()
    t0 = time.monotonic()
    msgs = _run(distributed_cases.mismatched, (scene, vp), tmp_path)
    assert time.monotonic() - t0 < DEADLINE
    for m in msgs:
        assert m is not None and "ncompact (rank 0: 2, rank 1: 0)" in m


def test_differences_and_shared_cards():
    a = dict(ncompact=2, ray_chunk=128, tables="x")
    assert distributed.differences([a, dict(a)]) == []
    assert distributed.differences([a, dict(a, ncompact=(True, False))]) == [
        "ncompact (rank 0: 2, rank 1: (True, False))"]
    assert distributed.shared_cards([("h", "0"), ("h", "1")]) == []
    assert distributed.shared_cards([("h", "0"), ("g", "0"), ("h", "0"),
                                     ("h", "0")]) == [2, 3]


def test_engine_fingerprint_sees_the_schedule_and_the_tables():
    scene, _ = _circles()
    one = distributed.engine_fingerprint(Engine(scene, ray_chunk=RB,
                                                device="cpu"))
    assert one == distributed.engine_fingerprint(
        Engine(scene, ray_chunk=RB, device="cpu"))
    assert distributed.differences([one, distributed.engine_fingerprint(
        Engine(scene, ray_chunk=RB, ncompact=0, device="cpu"))]) \
        == ["ncompact (rank 0: 2, rank 1: 0)"]
    lit, _ = _circles(lit=True)
    names = [d.split()[0] for d in distributed.differences(
        [one, distributed.engine_fingerprint(
            Engine(lit, ray_chunk=RB, page_size=48, auto_pages=False,
                   device="cpu"))])]
    assert {"page_size", "light", "tables"} <= set(names)


def test_rank_device_is_the_callers_or_a_card():
    assert distributed.rank_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            distributed.rank_device()


def test_backends_and_groups_are_checked(monkeypatch):
    """No process group, no torch.distributed, nccl for a rank on the CPU
    and a backend other than gloo or nccl each raise a clear error."""
    scene, vp = _circles()
    eng = Engine(scene, ray_chunk=RB, device="cpu")
    with pytest.raises(RuntimeError, match="no default process group"):
        distributed.engine_render_distributed(eng, vp)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    with pytest.raises(ValueError, match="use gloo for ranks on the CPU"):
        distributed.engine_render_distributed(eng, vp)
    monkeypatch.setattr(dist, "get_backend", lambda: "mpi")
    with pytest.raises(ValueError, match="gloo or nccl"):
        distributed.engine_render_distributed(eng, vp)
    monkeypatch.setattr(dist, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="not available"):
        distributed.trace_rays_distributed(
            upload_scene(scene, page_size=64, device="cpu"),
            torch.zeros((4, 3)), torch.zeros((4, 3)), prng_key(0), 2)
