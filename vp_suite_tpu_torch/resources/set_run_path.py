r"""Moves the run directory (``vp-suite-data``: checkpoints, data, logs) to
a new place, asked for on the terminal, and records it in the port's
``resources/local_config.json``; the JAX package's
``resources/set_run_path.py``::

    python -m vp_suite_tpu_torch.resources.set_run_path
"""
import shutil
import sys
from pathlib import Path

from vp_suite_tpu_torch.defaults import SETTINGS
from vp_suite_tpu_torch.utils.utils import timed_input


def main():
    cur = SETTINGS.RUN_PATH
    print(f"current run path: {cur}")
    new = timed_input("new run path", default=None, secs=60)
    if not new:
        print("no new path given, nothing to do")
        return
    new_path = Path(new).expanduser().resolve()
    if new_path == Path(cur).resolve():
        print("new path equals current path, nothing to do")
        return
    if Path(cur).exists():
        print(f"moving {cur} -> {new_path} ...")
        new_path.parent.mkdir(parents=True, exist_ok=True)
        shutil.move(str(cur), str(new_path))
    SETTINGS.set_run_path(new_path)
    print(f"run path set to {new_path}")


if __name__ == "__main__":
    sys.exit(main())
