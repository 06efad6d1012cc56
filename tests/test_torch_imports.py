"""Every module of the port imports when it is the first of the package
to be imported: no import cycle depends on another module having been
loaded before it (a cycle that goes through a package's `__init__`
fails only for some first modules, so a test suite that happens to load
them in another order does not see it).

One fresh interpreter walks the package and, for each module, drops
every module of the package from `sys.modules` and imports that one,
with jax, flax, optax and the JAX package unimportable: no module of the
port imports them.

And the port carries every public name of the JAX package: an AST walk
(no import) of each JAX module's top-level `def` and `class` names
without a leading underscore, each found if some module of the port
defines, assigns or imports it at top level; the names the port does not
port are listed with the reason.

And the port's quality harness carries every flag of the JAX tools it
ports (tools/train_to_ap.py, tools/train_supervisor.py), by an AST walk
of their `add_argument` calls.
"""

import ast
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WALK = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "flax", "optax",
               "mulit_view_object_detection_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, Block())
    import mulit_view_object_detection_torch as pkg
    names = sorted(m.name for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + "."))
    failed = []
    for name in names:
        for k in [k for k in sys.modules if k.startswith(pkg.__name__)]:
            del sys.modules[k]
        try:
            importlib.import_module(name)
        except Exception as e:
            failed.append(f"{name}: {e!r}")
    print(len(names))
    print("\\n".join(failed))
""")


# JAX names the port does not carry under their own name, and why
NOT_PORTED = {
    # they need the network
    "cli/download_interior.py": {"main"},
    "compat/__init__.py": {"download_trained_weights"},
    # TPU-only lowerings and the Pallas launch plumbing (the kernels are
    # kernels/unproject.py, kernels/reproject.py and csrc/)
    "kernels/unproject_pallas.py": {"auto_tile", "unproject_features_pallas",
                                    "unproject_features_pallas_fused"},
    "kernels/reproject_pallas.py": {"project_grid_pallas"},
    "models/fusion.py": {"GroupedGridFusion", "PhaseConvTranspose3D",
                         "ZfoldConv3D", "ZfoldPhaseConvTranspose3D"},
    "utils/bn_fold.py": {"fold_bn_variables", "group_fusion_variables"},
    # carried in the port's own form: train_step, val_step,
    # clip_per_tensor_norm, fold_bn_state_dict, and project_grid's two
    # methods as kernels/reproject.py::project_grid_nearest and
    # ops/projection.py::project_grid_trilinear
    "ops/projection.py": {"project_grid"},
    "train/step.py": {"TrainState", "create_train_state", "make_train_step",
                      "make_val_step"},
    "train/optim.py": {"clip_per_leaf_norm"},
}


def _public_defs(path):
    return {n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.ClassDef)) and not n.name.startswith("_")}


def _top_level_names(path):
    names = set()
    for n in ast.parse(path.read_text()).body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in n.names)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
    return names


def test_port_carries_every_public_name_of_the_jax_package():
    jax_root = pathlib.Path(ROOT, "mulit_view_object_detection_tpu")
    port = set().union(*(_top_level_names(p) for p in pathlib.Path(
        ROOT, "mulit_view_object_detection_torch").rglob("*.py")))
    missing = {}
    for path in sorted(jax_root.rglob("*.py")):
        rel = path.relative_to(jax_root).as_posix()
        names = _public_defs(path) - port - NOT_PORTED.get(rel, set())
        if names:
            missing[rel] = sorted(names)
    assert not missing, missing
    # every exception is still a name of the JAX package
    for rel, names in NOT_PORTED.items():
        assert names <= _public_defs(jax_root / rel), rel


def test_each_module_imports_first():
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-c", _WALK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    count, *failed = run.stdout.strip().split("\n")
    # 70 with cli/train_to_ap.py and cli/train_supervisor.py; 73 with
    # examples/ (its __init__, demo_synthetic, projection_playground)
    assert int(count) >= 73, run.stdout
    assert not [f for f in failed if f], failed


def _flags(path):
    """The option strings of every `add_argument` call in `path`."""
    flags = set()
    for n in ast.walk(ast.parse(pathlib.Path(path).read_text())):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "add_argument"):
            flags.update(a.value for a in n.args
                         if isinstance(a, ast.Constant)
                         and isinstance(a.value, str))
    return flags


@pytest.mark.parametrize("name", ["train_to_ap.py", "train_supervisor.py"])
def test_quality_harness_carries_every_flag(name):
    want = _flags(os.path.join(ROOT, "tools", name))
    got = _flags(os.path.join(ROOT, "mulit_view_object_detection_torch",
                              "cli", name))
    assert len(want) >= (41 if name == "train_to_ap.py" else 3)
    assert want <= got, sorted(want - got)
