"""The port's tutorial notebooks (``examples/make_notebooks.py`` and the
executed ``examples/notebooks/*.ipynb``) against the JAX repo's generator
``docs/make_notebooks.py``, loaded as a module from its file.

- Each notebook of ``BUILDERS`` has the same cell kinds, in the same
  order, as the JAX generator's notebook of the same name, and the same
  assertions;
- no code cell names JAX or the JAX package;
- the committed notebooks hold the generated cells, every code cell was
  executed and no output is an error;
- the two cheapest notebooks execute here with nbclient (120 s each).
"""
import importlib.util
import re
from pathlib import Path

import pytest

nbformat = pytest.importorskip("nbformat")

from mind_the_gaps_tpu_torch.examples import make_notebooks  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
NAMES = list(make_notebooks.BUILDERS)
JAX_NAME = re.compile(r"\bjax\b|mind_the_gaps_tpu(?!_torch)")


def _jax_generator():
    spec = importlib.util.spec_from_file_location("_jax_make_notebooks", ROOT / "docs" / "make_notebooks.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


J_GEN = _jax_generator()


def _assertions(nb):
    return [line.strip().split(",")[0] for c in nb.cells if c.cell_type == "code"
            for line in c.source.splitlines() if line.strip().startswith("assert ")]


def test_the_same_notebooks_as_the_jax_generator():
    assert NAMES == list(J_GEN.BUILDERS)


@pytest.mark.parametrize("name", NAMES)
def test_cells_follow_the_jax_notebook(name):
    mine, theirs = make_notebooks.BUILDERS[name](), J_GEN.BUILDERS[name]()
    assert [c.cell_type for c in mine.cells] == [c.cell_type for c in theirs.cells]
    assert _assertions(mine) == _assertions(theirs)


@pytest.mark.parametrize("name", NAMES)
def test_code_cells_do_not_name_jax(name):
    nb = make_notebooks.BUILDERS[name]()
    for cell in nb.cells:
        if cell.cell_type == "code":
            assert not JAX_NAME.search(cell.source), cell.source


@pytest.mark.parametrize("name", NAMES)
def test_committed_notebook_was_executed(name):
    path = make_notebooks.OUT / f"{name}.ipynb"
    assert path.is_file(), f"{path} is missing: python -m mind_the_gaps_tpu_torch.examples.make_notebooks"
    nb = nbformat.read(path, as_version=4)
    built = make_notebooks.BUILDERS[name]()
    assert [(c.cell_type, c.source) for c in nb.cells] == [(c.cell_type, c.source) for c in built.cells]
    code = [c for c in nb.cells if c.cell_type == "code"]
    assert code and all(isinstance(c.execution_count, int) for c in code)
    assert not [o for c in code for o in c.outputs if o.output_type == "error"]


@pytest.mark.parametrize("name", ["celerite_variance", "lomb_scargle_biases"])
def test_cheapest_notebooks_execute(name):
    pytest.importorskip("nbclient")
    from jupyter_client.kernelspec import KernelSpecManager, NoSuchKernel

    try:
        KernelSpecManager().get_kernel_spec("python3")
    except NoSuchKernel as err:
        pytest.skip(f"no python3 Jupyter kernel here: {err}")
    nb = make_notebooks.execute(name, timeout=120)
    code = [c for c in nb.cells if c.cell_type == "code"]
    assert all(isinstance(c.execution_count, int) for c in code)
    assert not [o for c in code for o in c.outputs if o.output_type == "error"]
