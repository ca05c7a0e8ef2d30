"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

The same numpy inputs go through the JAX package and its PyTorch
counterpart on the CPU. JAX runs f32 at 'highest' matmul precision
(tests/conftest.py); the port's CPU matmuls are plain f32.
"""
import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The suite runs under several xdist workers: keep torch's CPU threads
    from starving the JAX tests."""
    torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    """Card-only tests: decided here, at run time, never at import."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run `pytest -m gpu tests/` on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def t(x, dtype=torch.float32) -> torch.Tensor:
    """numpy / jax array -> CPU torch tensor."""
    return torch.as_tensor(np.array(x), dtype=dtype)


def n(x) -> np.ndarray:
    """torch tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def cameras_from_jax(cams):
    """JAX Cameras -> the port's Cameras with identical tensors."""
    from geosplatting_tpu_torch.graphics.cameras import Cameras

    return Cameras(
        c2w=t(cams.c2w), fx=t(cams.fx), fy=t(cams.fy), cx=t(cams.cx), cy=t(cams.cy),
        width=cams.width, height=cams.height, near=cams.near, far=cams.far,
    )


# --- injected draws of the stage-2 path -------------------------------------------
# The port's stage 2 takes its random numbers as tensors; these helpers replay
# the JAX package's key splits (geosplat_mc.py:167, :303-306, envshade.py:314-318,
# :374-388, geosplat_mc_trainer.py:217-221) into numpy arrays in the port's
# layout, so both packages see the same draws. JAX is imported here, not at
# the top: the card-only tests import this file where there is no JAX.


def jax_shade_draws(key, num_points: int, num_samples_x: int, light_bank: int = 2048) -> dict:
    """``env_shade``'s draws from ``key``: the bank's uniform jitter ``ub``,
    ``vb`` [m*m], and per step the bank entries ``bidx`` [S, N] and the BSDF
    sample's uniforms ``u`` [S, N, 3]."""
    import jax

    kb, key = jax.random.split(key)
    m2 = int(round(light_bank ** 0.5)) ** 2

    def step(sk):
        k1, _, k3, _ = jax.random.split(sk, 4)
        return (jax.random.randint(k1, (num_points,), 0, m2),
                jax.random.uniform(k3, (num_points, 3)))

    bidx, u = jax.vmap(step)(jax.random.split(key, num_samples_x * num_samples_x))
    return {"ub": np.asarray(jax.random.uniform(kb, (m2,))),
            "vb": np.asarray(jax.random.uniform(jax.random.fold_in(kb, 1), (m2,))),
            "bidx": np.asarray(bidx), "u": np.asarray(u)}


def jax_render_draws(key, num_faces: int, num_points: int, num_cameras: int,
                     num_samples_x: int, shade_keys=None) -> tuple[np.ndarray, list[dict]]:
    """``GeoSplatterMC.render``'s draws from ``key``: the face jitter noise
    [F, 3] and one ``jax_shade_draws`` per camera (from ``shade_keys`` when
    given, as the trainer passes them)."""
    import jax

    k_field, k_shade = jax.random.split(key)
    jitter = np.asarray(jax.random.normal(k_field, (num_faces, 3)))
    keys = shade_keys if shade_keys is not None else jax.random.split(k_shade, num_cameras)
    return jitter, [jax_shade_draws(k, num_points, num_samples_x) for k in keys]


def jax_step_draws(key, gt_shape, num_faces: int, num_points: int, num_samples_x: int) -> dict:
    """A stage-2 trainer step's draws from ``key``: the per-pixel
    background, the render key, the per-camera shade keys, the jitter noise
    and each camera's shade draws."""
    import jax

    k_render, k_bg = jax.random.split(key)
    shade_keys = jax.random.split(jax.random.fold_in(k_render, 1), gt_shape[0])
    jitter, draws = jax_render_draws(k_render, num_faces, num_points, gt_shape[0],
                                     num_samples_x, shade_keys=shade_keys)
    return {"background": np.asarray(jax.random.uniform(k_bg, tuple(gt_shape[:-1]) + (3,))),
            "k_render": k_render, "shade_keys": shade_keys, "jitter": jitter, "draws": draws}


def shade_draws(d: dict):
    """``jax_shade_draws`` output -> the port's ``ShadeDraws`` (CPU)."""
    from geosplatting_tpu_torch.ops.envshade import ShadeDraws

    return ShadeDraws(ub=t(d["ub"]), vb=t(d["vb"]), bidx=t(d["bidx"], torch.int64), u=t(d["u"]))


# --- injected draws of the stage-3 path -------------------------------------------
# GeoSplatterDefer.render splits its key into (k1, k2, k3): the ks jitter
# noise from k1, the per-camera shade keys from k3 unless the caller passes
# them (geosplat_defer.py:137-143, :286-289); its trainer splits a step's key
# into (k_render, k_bg) and passes split(fold_in(k_render, 1), B) as the
# shade keys (geosplat_defer_trainer.py:210-214). One point a pixel.


def jax_defer_draws(key, num_gaussians: int, num_points: int, num_cameras: int,
                    num_samples_x: int, shade_keys=None) -> tuple[np.ndarray, list[dict]]:
    """``GeoSplatterDefer.render``'s draws from ``key``: the ks jitter noise
    [N, 3] and one ``jax_shade_draws`` per camera."""
    import jax

    k1, _, k3 = jax.random.split(key, 3)
    jitter = np.asarray(jax.random.normal(k1, (num_gaussians, 3)))
    keys = shade_keys if shade_keys is not None else jax.random.split(k3, num_cameras)
    return jitter, [jax_shade_draws(k, num_points, num_samples_x) for k in keys]


def jax_defer_step_draws(key, gt_shape, num_gaussians: int, num_samples_x: int) -> dict:
    """A stage-3 trainer step's draws from ``key``: the per-pixel
    background, the render key, the per-camera shade keys, the ks jitter
    noise and each camera's shade draws."""
    import jax

    k_render, k_bg = jax.random.split(key)
    shade_keys = jax.random.split(jax.random.fold_in(k_render, 1), gt_shape[0])
    jitter, draws = jax_defer_draws(k_render, num_gaussians, gt_shape[1] * gt_shape[2],
                                    gt_shape[0], num_samples_x, shade_keys=shade_keys)
    return {"background": np.asarray(jax.random.uniform(k_bg, tuple(gt_shape[:-1]) + (3,))),
            "k_render": k_render, "shade_keys": shade_keys, "jitter": jitter, "draws": draws}


# --- injected draws of the mesh-prior path ----------------------------------------
# GeoSplatterPrior.render splits its key into (k_field, k_shade): the field's
# jitter from k_field (geosplat.py:498 for the shared field; :443-447, split
# in two, for the hash field), then with shadows k_shade into (k_shade,
# k_vox), the visibility grid's surface samples from k_vox (mesh.py:77-79,
# 2^17 of them, over the deformed mesh's areas); its trainer splits a step's
# key into (k_render, k_bg) and passes split(fold_in(k_render, 1), B) as the
# shade keys (geosplat_prior.py:141-166, geosplat_prior_trainer.py:122-131).


def jax_prior_step_draws(key, gt_shape, mesh_j, num_samples_x: int, hash_field: bool = False,
                         shadows: bool = True, num_surface: int = 1 << 17) -> dict:
    """A prior trainer step's draws from ``key``, for the deformed JAX mesh
    ``mesh_j``: the background, the render key, the shade keys, the jitter
    noise (the port's ``field.jitter_shape``), the surface draws (face ids,
    uniforms) and each camera's shade draws."""
    import jax
    import jax.numpy as jnp

    k_render, k_bg = jax.random.split(key)
    shade_keys = jax.random.split(jax.random.fold_in(k_render, 1), gt_shape[0])
    k_field, k_shade = jax.random.split(k_render)
    f = mesh_j.num_faces
    if hash_field:
        jitter = np.stack([np.asarray(jax.random.normal(k, (6 * f, 3)))
                           for k in jax.random.split(k_field)])
    else:
        jitter = np.asarray(jax.random.normal(k_field, (f, 3)))
    surface = None
    if shadows:
        _, k_vox = jax.random.split(k_shade)
        _, areas = mesh_j.face_normals_and_areas()
        k1, k2 = jax.random.split(k_vox)
        surface = (np.asarray(jax.random.categorical(k1, jnp.log(areas + 1e-20),
                                                     shape=(num_surface,))),
                   np.asarray(jax.random.uniform(k2, (num_surface, 2))))
    return {"background": np.asarray(jax.random.uniform(k_bg, tuple(gt_shape[:-1]) + (3,))),
            "k_render": k_render, "shade_keys": shade_keys, "jitter": jitter,
            "surface": surface,
            "draws": [jax_shade_draws(k, 6 * f, num_samples_x) for k in shade_keys]}
