"""Port parity: the hash-grid encoding and the hash-grid material field
(``GaussianField``) against the JAX package on the CPU.

The same seeded numpy inputs go through ``hashgrid_encode`` (values, table
and input gradients, with and without grad scaling; the uint32 hash wraps
modulo 2^32), ``get_gaussians_from_face`` and ``get_gaussians_from_vertex``
with a GaussianField (the face path in checkpointed chunks), the stage-2
``init_from_stage1`` from a stage-1 export of the hash field and the stage-3
hash roughness predictor (``apply_ks_bundle``). The field encoders are
small (4 levels, 2^8 rows a level) so each JAX program compiles in seconds;
the wrap-around test runs the default 16 levels up to resolution 4096.

Tolerances: the hash indices exactly; encodings atol 1e-6; the table's
gradient (sums of a few corner weights) atol 1e-5; the input gradient
(scaled by the table's finest resolution) 1e-5 of its largest entry;
Gaussian attributes atol 1e-5 (the two packages' vertex normals round
differently); field and vertex gradients through close_grads (1 % in L2,
2 % of the largest entry)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geosplatting_tpu.graphics.mesh import TriangleMesh as JMesh
from geosplatting_tpu.models import geosplat as jgs
from geosplatting_tpu.models.geosplat_defer import GeoSplatterDefer as JDefer
from geosplatting_tpu.models.geosplat_mc import GeoSplatterMC as JGeoSplatterMC
from geosplatting_tpu.models.geosplat_mc import export_stage1 as jexport_stage1
from geosplatting_tpu.models.mlp import MLPConfig
from geosplatting_tpu.ops import hashgrid as jhg
from geosplatting_tpu_torch.convert import params_from_numpy, params_to_numpy
from geosplatting_tpu_torch.graphics.mesh import TriangleMesh
from geosplatting_tpu_torch.models import geosplat as tgs
from geosplatting_tpu_torch.models.geosplat_defer import GeoSplatterDefer
from geosplatting_tpu_torch.models.geosplat_mc import GeoSplatterMC
from geosplatting_tpu_torch.ops import hashgrid as thg

from .test_torch_geosplat import close_grads
from .torch_parity import n, one_torch_thread, t  # noqa: F401

SMALL = dict(num_levels=4, min_res=4, max_res=64, log2_hashmap_size=8, grad_scaling=16.0)
HEADS = {"kd_enc": (3, "sigmoid", (8, 8)), "ks_enc": (2, "none", (8,)),
         "z_enc": (1, "none", (8,)), "occ_enc": (6, "none", (8, 8))}


def encs(name):
    """(JAX HashEncoding, the port's HashEncodingConfig) of a small head."""
    out, act, hidden = HEADS[name]
    jenc = jgs.HashEncoding(
        grid=jhg.HashGridConfig(**SMALL),
        mlp=MLPConfig(layers=(-1,) + hidden + (out,), activation=act, bias=False,
                      initialization="kaiming-uniform"))
    return jenc, tgs.HashEncodingConfig(grid=thg.HashGridConfig(**SMALL), hidden=hidden,
                                        out_dim=out, activation=act)


def fields(with_occ=True):
    names = [k for k in HEADS if with_occ or k != "occ_enc"]
    pairs = {k: encs(k) for k in names}
    jf = jgs.GaussianField(**{k: v[0] for k, v in pairs.items()})
    tf = tgs.GaussianField(**{k: v[1] for k, v in pairs.items()}, device="cpu")
    return jf, tf


def sphere_mesh(rows=5, cols=6, seed=0):
    """A UV sphere of radius 0.5 with jittered vertices and two masked faces."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0.2, np.pi - 0.2, rows + 1)
    ph = np.arange(cols) * 2 * np.pi / cols
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    v = np.stack((np.sin(tt) * np.cos(pp), np.cos(tt), np.sin(tt) * np.sin(pp)), -1)
    v = (v.reshape(-1, 3) * 0.5 + rng.normal(size=(v.size // 3, 3)) * 0.01).astype(np.float32)
    r, c = np.arange(rows)[:, None], np.arange(cols)[None, :]
    c1 = (c + 1) % cols
    f = np.concatenate((np.stack((r * cols + c, (r + 1) * cols + c, r * cols + c1), -1),
                        np.stack((r * cols + c1, (r + 1) * cols + c, (r + 1) * cols + c1), -1)),
                       0).reshape(-1, 3).astype(np.int32)
    mask = np.ones(len(f), bool)
    mask[[3, 17]] = False
    return v, f, mask


@pytest.mark.parametrize("grad_scaling", [None, 16.0])
def test_hashgrid_encode_matches_jax(grad_scaling):
    cfg = dict(num_levels=16, max_res=4096, log2_hashmap_size=12, grad_scaling=grad_scaling)
    rng = np.random.default_rng(1)
    table = rng.uniform(-1, 1, (16 * 4096, 2)).astype(np.float32)
    x = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    x[:4] = [[1, 1, 1], [-1, -1, -1], [0, 0.5, -0.5], [1, -1, 0]]   # corners: floor == ceil
    g = rng.normal(size=(400, 32)).astype(np.float32)

    def loss(tb, xx):
        return (jhg.hashgrid_encode(tb, xx, jhg.HashGridConfig(**cfg)) * g).sum()

    out_j = jax.jit(lambda a, b: jhg.hashgrid_encode(a, b, jhg.HashGridConfig(**cfg)))(table, x)
    gt_j, gx_j = jax.jit(jax.grad(loss, argnums=(0, 1)))(table, x)
    tt_, xt = t(table).requires_grad_(), t(x).requires_grad_()
    out_t = thg.hashgrid_encode(tt_, xt, thg.HashGridConfig(**cfg))
    (out_t * t(g)).sum().backward()
    np.testing.assert_allclose(n(out_t), np.asarray(out_j), atol=1e-6)
    np.testing.assert_allclose(n(tt_.grad), np.asarray(gt_j), atol=1e-5)
    gx_j = np.asarray(gx_j)
    assert np.abs(n(xt.grad) - gx_j).max() <= 1e-5 * np.abs(gx_j).max()
    cfg_t = thg.HashGridConfig(**cfg)
    np.testing.assert_array_equal(cfg_t.scalings, jhg.HashGridConfig(**cfg).scalings)
    assert cfg_t.output_dim == 32 and cfg_t.table_size == 4096


@pytest.mark.parametrize("table_size", [1 << 18, 1000])
def test_hash_wraps_like_uint32(table_size):
    """Coordinates whose products with the primes pass 2^32 (and negative
    ones, which uint32 wraps) hash to the JAX package's rows."""
    rng = np.random.default_rng(2)
    coords = np.concatenate([
        rng.integers(0, 4097, (500, 3)),
        rng.integers(-2 ** 31, 2 ** 31, (500, 3)),
    ]).astype(np.int32)
    assert (coords[:500].astype(np.int64) * 2654435761 >= 2 ** 32).any()
    want = np.asarray(jax.jit(lambda c: jhg._hash(c, table_size))(coords))
    got = n(thg.hash_index(torch.from_numpy(coords), table_size))
    np.testing.assert_array_equal(got, want)


def field_params(jf, tf, seed):
    """JAX field parameters with a table spread wide enough to matter,
    carried into the port's field."""
    params = jax.jit(jf.init)(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, params)
    for enc in params.values():
        enc["table"] = rng.uniform(-0.5, 0.5, enc["table"].shape).astype(np.float32)
    state = params_from_numpy({"field": params})
    tf.load_state_dict({k[len("field."):]: v for k, v in state.items()})
    return params


def test_gaussian_field_face_gaussians_match_jax():
    """get_gaussians_from_face with a GaussianField evaluated in chunks of 64
    rows (lax.map in JAX, checkpointed chunks here): the Gaussians, every
    attribute with the kd / ks jitter, and the gradients of a weighted sum
    of them into every encoder and the vertices."""
    jf, tf = fields()
    params = field_params(jf, tf, 3)
    v, f, mask = sphere_mesh()
    ig = np.array([-3.0, -3.0], np.float32)
    key = jax.random.key(4)
    k1, k2 = jax.random.split(key)
    npts = 6 * len(f)
    noise = np.stack([np.asarray(jax.random.normal(k, (npts, 3))) for k in (k1, k2)])
    rng = np.random.default_rng(5)
    w = {k: rng.normal(size=(npts, d)).astype(np.float32)
         for k, d in (("means", 3), ("kd", 3), ("ks", 2), ("occ", 6), ("kd_jitter", 3),
                      ("ks_jitter", 2))}

    def outs(splats, attrs):
        return {"means": splats.means, "kd": attrs.kd, "ks": attrs.ks, "occ": attrs.occ,
                "kd_jitter": attrs.kd_jitter, "ks_jitter": attrs.ks_jitter}

    def jax_loss(p, verts):
        mesh = JMesh(vertices=verts, indices=jnp.asarray(f), face_mask=jnp.asarray(mask))
        splats, attrs, _, _ = jgs.get_gaussians_from_face(
            jf, p, mesh, scale=0.8, initial_guess=jnp.asarray(ig), kd_perturb_std=0.01,
            ks_perturb_std=0.01, key=key, eval_chunk=64)
        o = outs(splats, attrs)
        return sum((o[k] * w[k]).sum() for k in w), o

    (grads_j, gv_j), o_j = jax.jit(jax.grad(jax_loss, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(v))
    verts = t(v).requires_grad_()
    mesh = TriangleMesh(vertices=verts, indices=t(f, torch.long), face_mask=t(mask, torch.bool))
    splats, attrs, _, valid = tgs.get_gaussians_from_face(
        tf, mesh, scale=0.8, initial_guess=t(ig), kd_perturb_std=0.01, ks_perturb_std=0.01,
        jitter_noise=t(noise), eval_chunk=64)
    assert tuple(tf.jitter_shape(len(f))) == noise.shape
    o_t = outs(splats, attrs)
    sum((o_t[k] * t(w[k])).sum() for k in w).backward()
    for k in w:
        np.testing.assert_allclose(n(o_t[k]), np.asarray(o_j[k]), atol=1e-5, err_msg=k)
    assert int(valid.sum()) == 6 * int(mask.sum())
    close_grads("vertices", n(verts.grad), np.asarray(gv_j))
    got = params_to_numpy({f"field.{k}": p.grad for k, p in tf.named_parameters()})["field"]
    for (path, gj), gt_ in zip(jax.tree_util.tree_leaves_with_path(grads_j),
                               jax.tree_util.tree_leaves(got)):
        close_grads(jax.tree_util.keystr(path), gt_, np.asarray(gj))


def test_gaussian_field_vertex_gaussians_match_jax():
    jf, tf = fields()
    params = field_params(jf, tf, 6)
    v, f, mask = sphere_mesh(seed=1)
    ig = np.array([0.0, -3.0], np.float32)
    mesh_j = JMesh(vertices=jnp.asarray(v), indices=jnp.asarray(f), face_mask=jnp.asarray(mask))
    splats_j, attrs_j, valid_j = jax.jit(lambda p: jgs.get_gaussians_from_vertex(
        jf, p, mesh_j, scale=0.8, initial_guess=jnp.asarray(ig)))(params)
    mesh_t = TriangleMesh(vertices=t(v), indices=t(f, torch.long), face_mask=t(mask, torch.bool))
    with torch.no_grad():
        splats_t, attrs_t, valid_t = tgs.get_gaussians_from_vertex(
            tf, mesh_t, scale=0.8, initial_guess=t(ig))
    np.testing.assert_array_equal(n(valid_t), np.asarray(valid_j))
    for k in ("kd", "ks", "occ", "normals"):
        np.testing.assert_allclose(n(getattr(attrs_t, k)), np.asarray(getattr(attrs_j, k)),
                                   atol=1e-5, err_msg=k)
    np.testing.assert_allclose(n(splats_t.means), np.asarray(splats_j.means), atol=1e-5)


def test_stage2_init_from_hash_bundle_matches_jax():
    """A JAX stage-1 export of the hash field into the port's stage 2 with a
    hash field: geometry, light and the ks encoder as JAX's
    init_from_stage1 puts them; the shared field refuses the bundle."""
    jf1, _ = fields(with_occ=False)
    s1 = jgs.GeoSplatter(resolution=6, light_resolution=8, scale=1.0, field=jf1)
    p1 = jax.jit(s1.init)(jax.random.key(7))
    export = jax.tree.map(np.asarray, jexport_stage1(s1, p1))
    assert sorted(export["ks_enc"]) == ["mlp", "table"]
    jf2, tf2 = fields()
    mj = JGeoSplatterMC(resolution=6, scale=1.0, field=jf2)
    params = jax.tree.map(np.asarray, jax.jit(mj.init_from_stage1)(export, jax.random.key(8)))
    mt = GeoSplatterMC(resolution=6, scale=1.0, field=tf2, device="cpu")
    mt.init_from_stage1(export)
    tree = params_to_numpy(mt.state_dict())
    for k in ("sdf", "deform", "weights", "exposure"):
        np.testing.assert_array_equal(tree[k], params[k], err_msg=k)
    np.testing.assert_allclose(tree["latlng"], params["latlng"], rtol=1e-5, atol=1e-6)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(params["field"]["ks_enc"]),
                            jax.tree_util.tree_leaves(tree["field"]["ks_enc"])):
        np.testing.assert_array_equal(b, a, err_msg=jax.tree_util.keystr(path))
    assert sorted(tree["field"]) == sorted(params["field"])
    # the JAX tree through the port's state dict and back, unchanged
    mt.load_state_dict(params_from_numpy(params))
    back = params_to_numpy(mt.state_dict())
    flat_a, def_a = jax.tree_util.tree_flatten(params)
    flat_b, def_b = jax.tree_util.tree_flatten(back)
    assert def_a == def_b and all(np.array_equal(a, b) for a, b in zip(flat_a, flat_b))
    with pytest.raises(ValueError, match="field family"):
        GeoSplatterMC(resolution=6, scale=1.0, triplane_resolution=8,
                      device="cpu").init_from_stage1(export)
    # the stage-2 export carries the hash ks and occ encoders
    exp2 = mt.export_model()
    assert sorted(exp2["ks_enc"]) == sorted(exp2["occ_enc"]) == ["mlp", "table"]


def test_stage3_hash_ks_bundle_matches_jax():
    """Stage 3 from a stage-2 export whose roughness predictor is a hash
    encoder: the per-Gaussian (roughness, metallic) of JAX's apply_ks_bundle
    and its gradient into the encoder; the stage-3 task picks the hash
    predictor for such an export."""
    jenc, tenc = encs("ks_enc")
    bundle = jax.tree.map(np.asarray, jax.jit(jenc.init)(jax.random.key(9)))
    rng = np.random.default_rng(10)
    bundle["table"] = rng.uniform(-0.5, 0.5, bundle["table"].shape).astype(np.float32)
    ng = 300
    means = rng.uniform(-0.6, 0.6, (ng, 3)).astype(np.float32)
    ig = np.array([-3.0, 0.0], np.float32)
    export = {
        "means": means, "scales": np.full((ng, 3), -4.0, np.float32),
        "quats": np.tile([1.0, 0, 0, 0], (ng, 1)).astype(np.float32),
        "opacities": np.zeros((ng, 1), np.float32), "normals": means,
        "kd": np.full((ng, 3), 0.5, np.float32), "occ": np.zeros((ng, 6), np.float32),
        "exposure": np.zeros(1, np.float32), "latlng": np.full((256, 512, 3), 0.5, np.float32),
        "ks_enc": bundle, "mc_vertices": np.zeros((3, 3), np.float32),
        "mc_indices": np.array([[0, 1, 2]], np.int32), "mc_face_mask": None,
        "initial_guess": ig, "sdf": np.zeros(8, np.float32),
    }
    md = JDefer(ks_enc=jenc, scale=1.05, resolution=1)
    wts = rng.normal(size=(ng, 2)).astype(np.float32)

    def ks_loss(b):
        ks = jax.nn.sigmoid(
            jgs.apply_ks_bundle(b, jnp.clip(jnp.asarray(means) / md.scale, -1, 1), md.ks_enc) + ig)
        return (ks * wts).sum(), ks

    grads_j, ks_j = jax.jit(jax.grad(ks_loss, has_aux=True))(bundle)
    mt = GeoSplatterDefer(num_gaussians=ng, ks_hash=tenc, scale=1.05, resolution=1, device="cpu")
    mt.init_from_stage2(export)
    ks_t = mt.gaussian_ks()
    (ks_t * t(wts)).sum().backward()
    np.testing.assert_allclose(n(ks_t), np.asarray(ks_j), atol=1e-6)
    got = params_to_numpy({f"field.{k}": p.grad for k, p in mt.ks_enc.named_parameters()})
    for (path, gj), gt_ in zip(jax.tree_util.tree_leaves_with_path(grads_j),
                               jax.tree_util.tree_leaves(got["field"])):
        close_grads(jax.tree_util.keystr(path), gt_, np.asarray(gj))
    state = params_to_numpy(mt.state_dict())
    assert sorted(state["ks_enc"]) == ["mlp", "table"]
    with pytest.raises(ValueError, match="layout"):
        GeoSplatterDefer(num_gaussians=ng, ks_resolution=8, device="cpu").init_from_stage2(export)
    from geosplatting_tpu_torch.engine.train_task import GeoSplatDeferTrainTask
    from geosplatting_tpu_torch.models.geosplat_defer import KS_ENC

    made = GeoSplatDeferTrainTask(resolution=1).make_model(export, "cpu")
    assert isinstance(made.ks_enc, tgs.HashEncoding) and made.ks_enc.config == KS_ENC
