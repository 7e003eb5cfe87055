"""Environment-variable configuration.

The analog of the reference's env knobs (``RTEN_TIMING`` parsed at
src/model.rs:128-148, ``env_flag`` at src/env.rs:10-20):

* ``RTEN_TPU_TIMING`` — enable per-op timing on every ``Model.run``;
  value syntax matches the reference: ``"sort=name by-shape=1"``.
* ``RTEN_TPU_EAGER=1`` — force eager execution (the port always runs
  eagerly; the flag is kept on ``RunOptions``).
* ``RTEN_TPU_NO_NATIVE=1`` — disable the C++ container reader.
"""

from __future__ import annotations

import os


def env_flag(name: str, default: bool = False) -> bool:
    value = os.environ.get(name)
    if value is None:
        return default
    return value not in ("", "0", "false", "no")


def timing_options_from_env(options=None):
    """Apply RTEN_TPU_TIMING / RTEN_TPU_EAGER to a RunOptions (creating
    one if needed). Returns the (possibly new) options object."""
    from ..runtime.executor import RunOptions

    spec = os.environ.get("RTEN_TPU_TIMING")
    eager = env_flag("RTEN_TPU_EAGER")
    if spec is None and not eager:
        return options
    options = options or RunOptions()
    if eager:
        options.eager = True
    if spec is not None:
        options.timing = True
        for part in spec.split():
            key, _, value = part.partition("=")
            if key == "sort" and value:
                options.timing_sort = value
            elif key == "by-shape":
                options.timing_by_shape = value not in ("", "0")
            elif key == "verbose":
                options.verbose = value not in ("", "0")
    return options
