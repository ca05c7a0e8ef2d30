"""The port's coverage of the JAX package, read from both source trees.

Every public module-level function or class, and every public method of a
class, in each ``geosplatting_tpu/**.py`` must have one of:

- the same name in the mirrored module of ``geosplatting_tpu_torch/``;
- an entry in ``RENAMED``: the port's names that do its work (in the
  mirrored module, or ``"other/module.py:Name"``);
- an entry in ``LEFT_OUT``: left out of the port by design, with the
  reason. This table is the one list of the port's by-design omissions
  (ROADMAP.md §A points here).

Both trees are parsed with ``ast``; neither package is imported, so the test
takes well under a second. The tables cannot rot: each entry must name
something the JAX module defines, every port name it maps to must exist,
and an entry whose JAX name the port now defines must go.

Run it alone: ``python -m pytest tests/test_torch_coverage.py -q``.
"""
import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "geosplatting_tpu"
PORT_PKG = ROOT / "geosplatting_tpu_torch"

# JAX module -> {JAX name: port names doing its work}
RENAMED = {
    "engine/train_task.py": {
        # the port's build() returns the model and the trainer holding its state
        "_TrainTaskBase.init_state": ("_TrainTaskBase.build",),
        "GeoSplatTrainTask.init_state": ("GeoSplatTrainTask.build",),
        "GeoSplatMCTrainTask.init_state": ("GeoSplatMCTrainTask.build",),
        "GeoSplatDeferTrainTask.init_state": ("GeoSplatDeferTrainTask.build",),
        "GeoSplatPriorTrainTask.init_state": ("GeoSplatPriorTrainTask.build",),
        "GSplatTrainTask.init_state": ("GSplatTrainTask.build",),
        # the data-parallel group's size: torch.distributed's world
        "GSplatTrainTask.mesh_size": ("_TrainTaskBase._start_ranks",),
    },
    "models/encodings.py": {
        "PosEncoding.apply": ("PosEncoding.forward",),
        "SHEncoding.apply": ("SHEncoding.forward",),
        "TriplaneEncoding.init": ("TriplaneEncoding.__init__",),
        "TriplaneEncoding.apply": ("TriplaneEncoding.forward",),
    },
    "models/geosplat.py": {
        "HashEncoding.init": ("HashEncoding.__init__",),
        "HashEncoding.apply": ("HashEncoding.forward",),
        "GaussianField.init": ("GaussianField.__init__",),
        "SharedField.init": ("SharedField.__init__",),
        "evaluate_field": ("SharedField.apply_all", "GaussianField.apply_all"),
        "apply_ks_bundle": ("KsBundle.forward",),
        # the grid, the parameters and the initial-guess buffer live on the module
        "GeoSplatter.make_grid": ("GeoSplatter.__init__",),
        "GeoSplatter.init": ("GeoSplatter.__init__",),
        "GeoSplatter.initial_guess_bias": ("GeoSplatter.__init__",),
    },
    "models/geosplat_defer.py": {
        "GeoSplatterDefer.frozen_geometry": ("frozen_geometry",),
    },
    "models/geosplat_mc.py": {
        "GeoSplatterMC.make_grid": ("GeoSplatterMC.__init__",),
        "GeoSplatterMC.initial_guess_bias": ("GeoSplatterMC.__init__",),
    },
    "models/geosplat_prior.py": {
        "GeoSplatterPrior.init": ("GeoSplatterPrior.__init__",),
        "GeoSplatterPrior.initial_guess_bias": ("GeoSplatterPrior.__init__",),
    },
    "models/mlp.py": {
        "MLPConfig": ("MLP",),
        "MLPConfig.init": ("MLP.__init__",),
        "MLPConfig.apply": ("MLP.forward",),
    },
    "ops/rasterize_pairs.py": {
        # the CUDA composite (K1, K2 with K3) and its device-side chunk list
        "composite_pairs_pallas": ("composite_pairs",),
        "chunk_budget": ("chunk_list",),
        "pick_chunk_size": ("chunk_list",),
    },
    "ops/segment_rows.py": {
        "blocked_cumsum": ("cumsum_rows",),   # K3's wrapper
    },
    "train/dp.py": {
        "dp_value_and_grad": ("reduce_grads", "reduce_aux"),   # the all-reduce
    },
    "train/geosplat_trainer.py": {
        "GeoSplatTrainer.init_state": ("GeoSplatTrainer.__init__",),
    },
    "train/geosplat_mc_trainer.py": {
        "GeoSplatMCTrainer.init_state": ("GeoSplatMCTrainer.__init__",),
        "GeoSplatMCTrainer.train_step_accum": ("GeoSplatMCTrainer.train_step",),
    },
    "train/geosplat_defer_trainer.py": {
        "GeoSplatDeferTrainer.init_state": ("GeoSplatDeferTrainer.__init__",),
        "GeoSplatDeferTrainer.train_step_accum": ("GeoSplatDeferTrainer.train_step",),
    },
    "train/geosplat_prior_trainer.py": {
        "GeoSplatPriorTrainer.init_state": ("GeoSplatPriorTrainer.__init__",),
        "GeoSplatPriorTrainer.train_step_accum": ("GeoSplatPriorTrainer.train_step",),
    },
    "train/gsplat_trainer.py": {
        "splats_to_params": ("GSplatTrainer.init_state",),
        "params_to_splats": ("GSplatTrainer.splats",),
    },
    "train/optim.py": {
        "OptimizerSpec.build": ("OptimizerSpec.schedule", "GroupOptimizers.__init__"),
        "GroupOptimizers.init": ("GroupOptimizers.__init__",),
        "GroupOptimizers.update": ("GroupOptimizers.step",),
    },
}

# JAX module -> {JAX name, or "*" for the whole module: the reason}
LEFT_OUT = {
    "utils/tensorclass.py": {
        "*": "the pytree dataclass base; the port's dataclasses of tensors serve it",
    },
    "data/downloaders.py": {
        "*": "its only job is a download, and neither machine has a network",
    },
    "train/optim.py": {
        "mutate_optax_state": "optax state surgery; GroupOptimizers.mutate_params does it "
                              "on the port's Adam state",
    },
    "models/geosplat.py": {
        "field_group_names": "a field pytree helper; the port's fields are modules whose "
                             "param_groups() name their groups",
        "field_to_groups": "a field pytree helper (see field_group_names)",
        "field_from_groups": "a field pytree helper (see field_group_names)",
        "GeoSplatter.get_background": "no caller: the stage-1 trainer draws its own "
                                      "per-pixel background, as the JAX one does",
    },
    "models/geosplat_prior.py": {
        "GeoSplatterPrior.get_background": "no caller: the prior trainer composites over its "
                                           "own random background; the port's model has no "
                                           "background_color",
    },
    "parallel/sharding.py": {
        "make_mesh": "JAX device-mesh plumbing; torch.distributed groups "
                     "(init_from_env, spawn_gloo) take its place",
    },
}


def public_names(path: Path, private: bool = False) -> dict[str, int]:
    """{name: line} of the module-level functions and classes of ``path``,
    and of every class's methods as ``Class.method``; public ones only
    unless ``private``."""
    def keep(name: str) -> bool:
        return private or not name.startswith("_")

    out = {}
    for node in ast.parse(path.read_text(), filename=str(path)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if keep(node.name):
                out[node.name] = node.lineno
            if isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)) and keep(sub.name):
                        out[f"{node.name}.{sub.name}"] = sub.lineno
    return out


def jax_modules() -> list[str]:
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


_PORT_CACHE: dict[str, dict[str, int]] = {}


def port_names(module: str) -> dict[str, int]:
    """Every name (private too) the port's ``module`` defines; {} without it."""
    if module not in _PORT_CACHE:
        path = PORT_PKG / module
        _PORT_CACHE[module] = public_names(path, private=True) if path.exists() else {}
    return _PORT_CACHE[module]


def resolve(module: str, target: str) -> tuple[str, str]:
    """A RENAMED target -> (port module, name)."""
    return tuple(target.split(":")) if ":" in target else (module, target)


def test_every_jax_name_is_ported_renamed_or_left_out():
    gaps = []
    for module in jax_modules():
        left_out = LEFT_OUT.get(module, {})
        renamed = RENAMED.get(module, {})
        port = port_names(module)
        for name, line in public_names(JAX_PKG / module).items():
            if "*" in left_out or name in left_out or name in renamed:
                continue
            if name not in port:
                gaps.append(f"geosplatting_tpu/{module}:{line} {name}")
    assert not gaps, ("JAX names the port neither defines nor lists in RENAMED / LEFT_OUT "
                      "(tests/test_torch_coverage.py):\n" + "\n".join(gaps))


def test_renamed_table_names_what_exists_on_both_sides():
    problems = []
    for module, entries in RENAMED.items():
        jax_defs = public_names(JAX_PKG / module) if (JAX_PKG / module).exists() else {}
        for name, targets in entries.items():
            if name not in jax_defs:
                problems.append(f"{module} {name}: not in the JAX module")
            if name in port_names(module):
                problems.append(f"{module} {name}: the port now defines it; drop the entry")
            for target in targets:
                mod, tname = resolve(module, target)
                if tname not in port_names(mod):
                    problems.append(f"{module} {name}: geosplatting_tpu_torch/{mod} has no "
                                    f"{tname}")
    assert not problems, "\n".join(problems)


def test_left_out_table_names_what_exists_and_stays_unported():
    problems = []
    for module, entries in LEFT_OUT.items():
        jax_defs = public_names(JAX_PKG / module) if (JAX_PKG / module).exists() else {}
        for name, reason in entries.items():
            assert reason.strip(), (module, name)
            if name == "*":
                if not jax_defs:
                    problems.append(f"{module}: no JAX module of public names")
                if (PORT_PKG / module).exists():
                    problems.append(f"{module}: the port now has this module; drop the entry")
                continue
            if name not in jax_defs:
                problems.append(f"{module} {name}: not in the JAX module")
            if name in port_names(module):
                problems.append(f"{module} {name}: the port now defines it; drop the entry")
    assert not problems, "\n".join(problems)
