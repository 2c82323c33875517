"""Run one of the port's notebooks in this process, without a Jupyter kernel.

The code cells of ``variantformer_tpu_torch/notebooks/<name>.ipynb`` run in
order in one namespace; ``parameters`` are assigned right after the cell
tagged ``parameters`` (papermill's convention). What a notebook would show
is recorded as outputs: ``display(...)`` calls, the value of a cell's last
expression, and each figure a cell leaves open (as PNG, as Jupyter's inline
backend shows it). Where ``IPython`` is not installed, a minimal
``IPython.display`` (``display``, ``HTML``) stands in for it.

    python -m variantformer_tpu_torch.scripts.run_notebook NAME [--device cpu] [--root DIR]
"""

from __future__ import annotations

import argparse
import ast
import base64
import contextlib
import dataclasses
import importlib.util
import io
import json
import sys
import types
import warnings
from pathlib import Path
from typing import Callable

from variantformer_tpu_torch.scripts.make_notebooks import NOTEBOOKS_DIR


class NotebookError(RuntimeError):
    """A cell raised; the message names the notebook and the cell."""


@dataclasses.dataclass
class Run:
    namespace: dict
    outputs: list[dict]  # {"cell", "output_type", "data": {mime: text}}
    skipped: list[tuple[int, str]]  # (cell index, reason)
    stub_ipython: bool  # the minimal IPython.display stood in


def load(name: str | Path) -> dict:
    """A notebook as JSON: a name under ``notebooks/`` or a path."""
    path = Path(name)
    if path.suffix != ".ipynb":
        path = NOTEBOOKS_DIR / f"{name}.ipynb"
    return json.loads(path.read_text())


def source(cell: dict) -> str:
    src = cell["source"]
    return src if isinstance(src, str) else "".join(src)


def imported_modules(src: str) -> set[str]:
    """The top-level names of the modules ``src`` imports."""
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def missing_modules(src: str) -> list[str]:
    """The modules ``src`` imports that are not installed, but for
    ``IPython``, which ``run`` stands in for."""
    return sorted(m for m in imported_modules(src) - {"IPython"}
                  if importlib.util.find_spec(m) is None)


def _bundle(obj) -> dict:
    data = {"text/plain": repr(obj)}
    html = getattr(obj, "_repr_html_", None)
    if callable(html) and (text := html()) is not None:
        data["text/html"] = text
    if hasattr(obj, "savefig") and hasattr(obj, "canvas"):  # a matplotlib Figure
        buf = io.BytesIO()
        obj.savefig(buf, format="png")
        data["image/png"] = base64.b64encode(buf.getvalue()).decode()
    return data


class _HTML:
    """``IPython.display.HTML`` for a process without IPython."""

    def __init__(self, data: str = ""):
        self.data = data

    def _repr_html_(self) -> str:
        return self.data


@contextlib.contextmanager
def _display_recorder(record: Callable):
    """``IPython.display.display`` replaced by ``record`` (or a minimal
    ``IPython.display`` where IPython is missing); yields whether the
    minimal module stood in."""
    if importlib.util.find_spec("IPython") is not None:
        import IPython.display as ipd

        saved = ipd.display
        ipd.display = record
        try:
            yield False
        finally:
            ipd.display = saved
        return
    stub = types.ModuleType("IPython")
    stub.display = types.ModuleType("IPython.display")
    stub.display.display, stub.display.HTML = record, _HTML
    sys.modules["IPython"], sys.modules["IPython.display"] = stub, stub.display
    try:
        yield True
    finally:
        sys.modules.pop("IPython", None)
        sys.modules.pop("IPython.display", None)


def _flush_figures(record: Callable) -> None:
    plt = sys.modules.get("matplotlib.pyplot")
    if plt is None:
        return
    for num in plt.get_fignums():
        record(plt.figure(num))
    plt.close("all")


def run(nb: dict, parameters: dict | None = None,
        skip: Callable[[int, str], str | None] | None = None) -> Run:
    """Run ``nb``'s code cells in order in one namespace. ``parameters``
    are assigned after the cell tagged ``parameters``, and each must be a
    name that cell assigns. ``skip(index, source)`` returns a reason to
    leave a cell out, or None. A cell that raises raises ``NotebookError``."""
    parameters = dict(parameters or {})
    cells = [(i, c) for i, c in enumerate(nb["cells"]) if c["cell_type"] == "code"]
    tagged = [i for i, c in cells if "parameters" in c.get("metadata", {}).get("tags", [])]
    if len(tagged) != 1:
        raise NotebookError(f"{len(tagged)} cells tagged 'parameters', want 1")
    declared = {t.id for node in ast.parse(source(nb["cells"][tagged[0]])).body
                if isinstance(node, ast.Assign) for t in node.targets
                if isinstance(t, ast.Name)}
    if unknown := set(parameters) - declared:
        raise NotebookError(f"parameters {sorted(unknown)} are not in the parameters cell")
    if importlib.util.find_spec("matplotlib") is not None:
        import matplotlib

        matplotlib.use("Agg")  # figures are recorded, never shown
    ns: dict = {"__name__": "__main__"}
    outputs: list[dict] = []
    skipped: list[tuple[int, str]] = []
    index = [0]

    def record(*objs, **_):
        for obj in objs:
            outputs.append({"cell": index[0], "output_type": "display_data",
                            "data": _bundle(obj)})

    with _display_recorder(record) as stub, warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*non-interactive.*")
        for i, cell in cells:
            index[0] = i
            src = source(cell)
            if skip is not None and (reason := skip(i, src)) is not None:
                skipped.append((i, reason))
                continue
            tree = ast.parse(src)
            last = tree.body.pop() if tree.body and isinstance(tree.body[-1], ast.Expr) else None
            stdout = io.StringIO()
            try:
                with contextlib.redirect_stdout(stdout):
                    exec(compile(tree, f"<cell {i}>", "exec"), ns)
                    value = (eval(compile(ast.Expression(last.value), f"<cell {i}>", "eval"), ns)
                             if last is not None else None)
            except Exception as exc:
                raise NotebookError(f"cell {i} raised {type(exc).__name__}: {exc}\n"
                                    f"its output:\n{stdout.getvalue()[-2000:]}") from exc
            if stdout.getvalue():
                outputs.append({"cell": i, "output_type": "stream",
                                "data": {"text/plain": stdout.getvalue()}})
            if value is not None:
                outputs.append({"cell": i, "output_type": "execute_result",
                                "data": _bundle(value)})
            _flush_figures(record)
            if i == tagged[0]:
                ns.update(parameters)
    return Run(ns, outputs, skipped, stub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("name", help="notebook name under notebooks/, or a path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--root", default=None, help="work directory (default: under TMPDIR)")
    args = ap.parse_args(argv)
    done = run(load(args.name), {"DEVICE": args.device, "ROOT": args.root})
    for out in done.outputs:
        print(f"[cell {out['cell']} {out['output_type']}]")
        print(out["data"]["text/plain"] if "image/png" not in out["data"] else "<figure>")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
