"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of the
batched trec_eval evaluator: ``python3 -m evalbench.run --workload <name>
--seed <n> --seconds <s> --trace <0|1>``.

Whatever belongs to one configuration kind, docno style, traffic mix,
entry or metric sits in a file of its own under this folder, found by the
name that ``BENCHMARK.json`` or a configuration file gives it."""

import importlib.util
import types
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_module(path: Path, name: str) -> types.ModuleType:
    """Import the Python file ``path`` as module ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def found(folder: str, name: str) -> types.ModuleType:
    """The module ``<folder>/<name>.py`` of the benchmark."""
    path = HERE / folder / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no file {path.relative_to(HERE.parent)}")
    return load_module(path, f"evalbench_{folder}_"
                       + name.replace(".", "_").replace("-", "_"))
