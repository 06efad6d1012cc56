"""Every module of the port imports when it is the first of the package
to be imported: no import cycle depends on another module having been
loaded before it (a cycle that goes through a package's `__init__`
fails only for some first modules, so a test suite that happens to load
them in another order does not see it).

One fresh interpreter walks the package and, for each module, drops
every module of the package from `sys.modules` and imports that one.
"""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WALK = textwrap.dedent("""
    import importlib, pkgutil, sys
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


def test_each_module_imports_first():
    env = dict(os.environ, PYTHONPATH=ROOT)
    run = subprocess.run([sys.executable, "-c", _WALK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr
    count, *failed = run.stdout.strip().split("\n")
    assert int(count) >= 60, run.stdout
    assert not [f for f in failed if f], failed
