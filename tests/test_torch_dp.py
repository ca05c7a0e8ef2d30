"""Port parity: multi-GPU training and the sharded renders on
``torch.distributed``, with two gloo ranks on the CPU (spawned once for the
file, rendezvous through a file in the test's temporary directory: no TCP
port to collide under xdist; ``tests/torch_dp_workers.py`` runs in them).

- ``train_step_dp`` of stages 1-3 and 3DGS on 2 ranks against the same
  trainer's ``train_step`` on the whole batch in this process, from the
  same seeds and generator state. Tolerances, the JAX package's own between
  its DP and single-device steps (tests/test_dp_geosplat.py:98-99, 174,
  222): the loss within rtol 1e-4; the gradients within rtol 1e-3, atol
  2e-5 (stage 1, 3DGS, and 3DGS's densification statistics) and rtol
  2e-3, atol 2e-5 (stages 2, 3). After a second step every parameter is
  bit-equal across the ranks.
- The band-sharded and the Gaussian-sharded renders on 2 ranks against the
  JAX package's ``rasterize_tile_sharded`` / ``rasterize_gs_sharded`` on a
  2-device mesh, at tests/test_tile_sharding.py's shapes (400 Gaussians,
  96 x 80): images within atol 3e-5 (band, tests/test_tile_sharding.py:36-37)
  and 1e-5 (Gaussian-sharded, tests/test_gs_sharding.py:50-52); their
  gradients against the port's single-process render, at that test's own
  scene (512 random Gaussians of SH degree 1 at 64 x 48), within 2e-4 (its
  bound, tests/test_gs_sharding.py:79) times the largest entry of each
  gradient where that exceeds 1: the images are equal, but a Gaussian's
  gradient sums its band's pair rows apart from the other band's (segment
  sums are differences of prefix sums, which round with the running
  prefix), so the entries differ by up to ~6e-5 of their tensor's largest
  entry, past an absolute 2e-4 once that entry is ~80 (measured here).
- A data-parallel ``GSplatTrainTask``: rank 0 alone writes the run
  directory, its export equals its last checkpoint; a batch the world size
  does not divide raises, naming both numbers.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.parallel.gs_sharding import rasterize_gs_sharded as jax_gs_sharded
from geosplatting_tpu.parallel.sharding import make_mesh
from geosplatting_tpu.parallel.tile_sharding import rasterize_tile_sharded as jax_tile_sharded
from geosplatting_tpu_torch.engine.stage_io import load_export
from geosplatting_tpu_torch.ops.rasterize import rasterize
from geosplatting_tpu_torch.parallel import sharding

from . import torch_dp_workers as w
from .torch_parity import one_torch_thread  # noqa: F401
from .torch_scenes import write_sphere_scene

TOL = {"stage1": (1e-3, 2e-5), "gsplat": (1e-3, 2e-5), "stage2": (2e-3, 2e-5),
       "stage3": (2e-3, 2e-5)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two gloo ranks' results (``torch_dp_workers.dp_rank``) and, computed
    here while they run, the same setups' single-process step on the whole
    batch."""
    root = tmp_path_factory.mktemp("dp")
    scene = root / "scene"
    write_sphere_scene(scene, {"train": 4, "val": 1, "test": 1}, w.W, "cpu")
    out = root / "out"
    out.mkdir()
    ctx = sharding.spawn_gloo(w.dp_rank, 2, root / "rendezvous", str(out), str(scene),
                              join=False)
    try:
        torch.set_num_threads(1)
        single = {}
        for name, setup in w.SETUPS.items():
            trainer, cams, gt = setup()
            gen = torch.Generator().manual_seed(w.STEP_SEED)
            single[name] = w.snapshot(name, trainer,
                                      w.step(name, trainer, cams, gt, gen, dp=False))
    finally:
        deadline = time.monotonic() + 600
        while not ctx.join(timeout=max(deadline - time.monotonic(), 1)):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.terminate()
                raise TimeoutError("the gloo ranks did not finish in 600 s")
    return out, [torch.load(out / f"rank{r}.pt") for r in range(2)], single


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[:2]


@pytest.fixture(scope="module")
def single(runs):
    return runs[2]


@pytest.mark.parametrize("name", list(w.SETUPS))
def test_dp_step_matches_single_process(ranks, single, name):
    _, (r0, _) = ranks
    got, want = r0[name], single[name]
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-4)
    assert got["metrics"]["nonfinite_grads"] == 0
    assert got["metrics"]["dp_reduce_bytes"] > 0
    rtol, atol = TOL[name]
    assert got["grads"].keys() == want["grads"].keys()
    for k in want["grads"]:
        np.testing.assert_allclose(got["grads"][k].numpy(), want["grads"][k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"{name} {k}")
    for k, v in want.get("stats", {}).items():
        np.testing.assert_allclose(got["stats"][k].numpy(), v.numpy(), rtol=rtol, atol=atol,
                                   err_msg=k)


@pytest.mark.parametrize("name", list(w.SETUPS))
def test_dp_ranks_stay_bit_equal(ranks, name):
    _, (r0, r1) = ranks
    for k, p in r0[name]["params"].items():
        assert torch.equal(p, r1[name]["params"][k]), f"{name} {k}"


def test_indivisible_batch_raises(ranks):
    _, (r0, r1) = ranks
    for r in (r0, r1):
        assert "batch of 3" in r["indivisible"] and "2 ranks" in r["indivisible"]
        assert "batch_size 3" in r["task_indivisible"] and "2 ranks" in r["task_indivisible"]


def test_dp_task_writes_on_rank0_only(ranks):
    out, (r0, r1) = ranks
    assert r1["task"]["output_dir"] is None
    runs = list((out / "outputs" / "gsplat").iterdir())
    assert [p.resolve() for p in runs] == [(out / r0["task"]["output_dir"]).resolve()]
    run = runs[0]
    for f in ("task.py", "log.txt", "export.npz", "ckpts/1.pt", "ckpts/2.pt"):
        assert (run / f).exists(), f
    assert "data_parallel=True" in (run / "task.py").read_text()
    exported = load_export(run)
    ckpt = torch.load(run / "ckpts" / "2.pt")
    for k, v in ckpt["params"].items():
        np.testing.assert_array_equal(exported[k], v.numpy(), err_msg=k)
    assert r0["task"]["nonfinite_grads"] == 0 and r0["task"]["loss"] == r1["task"]["loss"]


def test_start_ranks_without_group_changes_nothing(monkeypatch):
    from geosplatting_tpu_torch.engine.train_task import GSplatTrainTask

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    task = GSplatTrainTask(data_parallel=True, device="cpu")
    assert task._start_ranks() == (0, 1, torch.device("cpu"))
    assert not sharding.is_distributed()


@pytest.fixture(scope="module")
def jax_sharded():
    """The JAX sharded renders of the "forward" scene on a 2-device mesh,
    each jitted (the dense reference backend, as the JAX tests run them)."""
    arrays, cam, _ = w.render_inputs("forward")
    args = (*(jnp.asarray(v) for v in arrays.values()), jnp.asarray(cam.view_matrix.numpy()),
            jnp.asarray(cam.intrinsic_matrix.numpy()))
    width, height = w.SCENES["forward"]
    fns = {"tile": (jax_tile_sharded, make_mesh(2, axis_name="tp"), "tp", {}),
           "gs": (jax_gs_sharded, make_mesh(2, axis_name="gs"), "gs", {"backend": "reference"})}
    out = {}
    for kind, (fn, mesh, axis, kw) in fns.items():
        out[kind] = jax.jit(lambda *a, fn=fn, mesh=mesh, axis=axis, kw=kw: fn(
            mesh, axis, *a, width, height, tile_capacity=256, tile_chunk=4, **kw,
            **w.SHARDED_KW[kind]))(*args)
    return out


@pytest.mark.parametrize("kind,atol", [("tile", 3e-5), ("gs", 1e-5)])
def test_sharded_render_matches_jax(ranks, jax_sharded, kind, atol):
    _, (r0, r1) = ranks
    want_render, want_alpha = (np.asarray(x) for x in jax_sharded[kind])
    for r in (r0, r1):
        got = r["sharded"][("forward", kind)]
        np.testing.assert_allclose(got["render"].numpy(), want_render, atol=atol)
        np.testing.assert_allclose(got["alpha"].numpy(), want_alpha, atol=atol)


@pytest.mark.parametrize("kind", ["tile", "gs"])
def test_sharded_render_gradients(ranks, kind):
    _, (r0, r1) = ranks
    arrays, cam, kw = w.render_inputs("grads")
    scene = {k: torch.from_numpy(v).requires_grad_(True) for k, v in arrays.items()}
    render, alpha, _ = rasterize(*scene.values(), cam.view_matrix, cam.intrinsic_matrix,
                                 *w.SCENES["grads"], **kw)
    w.render_loss(render, alpha).backward()
    for k, v in scene.items():
        got = [r["sharded"][("grads", kind)][k] for r in (r0, r1)]
        if kind == "tile":   # every rank holds every Gaussian's whole gradient
            assert torch.equal(got[0], got[1])
            got = got[0]
        else:                # each rank its own Gaussians'
            got = torch.cat(got)
        np.testing.assert_allclose(got.numpy(), v.grad.numpy(),
                                   atol=2e-4 * max(1.0, float(v.grad.abs().max())),
                                   err_msg=k)
