"""The JAX package's measurement scripts under tools/, loaded for the
port's CPU tests: each is loaded from its file under a private name (no
tool file is edited), with `jax.config.update` stubbed while it loads
(some set JAX's persistent compilation cache at import) and sys.path
restored after (some insert the repository), so nothing of theirs
outlives the load. `InterpretPl` stands in for a tool's `pl`."""

import importlib.util
import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class InterpretPl:
    """Stands in for a tool module's `pl`: every pallas_call runs in
    interpret mode, overriding any `interpret=` the tool passes, and each
    call records (callable, args, outputs)."""

    def __init__(self, real):
        self._real = real
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._real, name)

    def pallas_call(self, kernel, **kw):
        kw["interpret"] = True
        f = self._real.pallas_call(kernel, **kw)

        def call(*args):
            out = f(*args)
            self.calls.append((call, args, out))
            return out

        return call


def load_tool(name: str):
    """tools/<name>.py as a module of its own, sys.path and JAX's config as
    they were before the load."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    tool = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    cache_dir = jax.config.jax_compilation_cache_dir
    try:
        with pytest.MonkeyPatch.context() as m:
            m.setattr(jax.config, "update", lambda *a, **k: None)
            spec.loader.exec_module(tool)
    finally:
        sys.path[:] = path
    assert jax.config.jax_compilation_cache_dir == cache_dir
    return tool


def interpret_tool(monkeypatch, name: str):
    """load_tool(name) with its `pl` replaced by an InterpretPl for the
    test's duration."""
    tool = load_tool(name)
    monkeypatch.setattr(tool, "pl", InterpretPl(tool.pl))
    return tool
