"""Config as code and a dataclass CLI.

Counterpart of ``geosplatting_tpu/utils/config.py``: ``dump_dataclass_as_str``
writes a (nested) dataclass instance as a Python script that rebuilds it,
``load_dataclass`` runs such a script, and ``run_task_group`` turns named
task presets into subcommands whose fields are ``--dotted.path`` flags.
Task-runtime flags: ``--profiling PATH`` (cProfile stats), ``--trace DIR``
(a ``torch.profiler`` Chrome trace), ``--auto-breakpoint`` (pdb post-mortem
on a crash), ``--detach`` (run in a detached subprocess, logging to
``--detach-log``) and ``--join-timeout SECONDS``.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import sys
import typing
from pathlib import Path
from typing import Any


def dump_dataclass_as_str(obj: Any, name: str = "task") -> str:
    """Serialize a (nested) dataclass instance as an executable script that
    rebuilds it into the module-level variable ``name``; fields left at
    their defaults are omitted."""
    modules = {}

    def render(x) -> str:
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            cls = type(x)
            modules[cls.__module__] = None
            fields = []
            for f in dataclasses.fields(x):
                v = getattr(x, f.name)
                if f.default is not dataclasses.MISSING:
                    default = f.default
                elif f.default_factory is not dataclasses.MISSING:
                    default = f.default_factory()
                else:
                    default = dataclasses.MISSING
                try:
                    skip = v == default
                except Exception:
                    skip = False
                if skip is True:
                    continue
                fields.append(f"{f.name}={render(v)}")
            return f"{cls.__module__}.{cls.__qualname__}({', '.join(fields)})"
        if isinstance(x, Path):
            modules["pathlib"] = None
            return f"pathlib.Path({str(x)!r})"
        if isinstance(x, (list, tuple)):
            inner = ", ".join(render(v) for v in x)
            if isinstance(x, list):
                return f"[{inner}]"
            return f"({inner},)" if len(x) == 1 else f"({inner})"
        if isinstance(x, dict):
            return "{" + ", ".join(f"{render(k)}: {render(v)}" for k, v in x.items()) + "}"
        return repr(x)

    body = render(obj)
    imports = "\n".join(f"import {m}" for m in sorted(modules))
    return f"{imports}\n\n{name} = {body}\n"


def load_dataclass(script_path: Path, name: str = "task") -> Any:
    """Execute a dumped config script and return its ``name`` object."""
    spec = importlib.util.spec_from_file_location("_loaded_task", script_path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return getattr(mod, name)


# --- dataclass CLI ------------------------------------------------------------


def _resolve_field_type(cls, f: dataclasses.Field):
    """Concrete Python type of a dataclass field: resolves string
    annotations and unwraps ``X | None``."""
    t = f.type
    if isinstance(t, str):
        try:
            t = typing.get_type_hints(cls).get(f.name, str)
        except Exception:
            return str
    origin = typing.get_origin(t)
    if origin is typing.Union or str(origin) == "<class 'types.UnionType'>":
        args = [a for a in typing.get_args(t) if a is not type(None)]
        t = args[0] if args else str
    return t if isinstance(t, type) else str


def _add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str = ""):
    for f in dataclasses.fields(cls):
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(type(f.default)) and not isinstance(f.default, type):
            _add_dataclass_args(parser, type(f.default), prefix=f"{name}.")
            continue
        typ = _resolve_field_type(cls, f)
        if dataclasses.is_dataclass(typ):
            _add_dataclass_args(parser, typ, prefix=f"{name}.")
        elif typ is bool:
            parser.add_argument(f"--{name}", type=lambda s: s.lower() in ("1", "true", "yes"))
        elif typ in (int, float, str, Path):
            parser.add_argument(f"--{name}", type=typ)
        else:
            parser.add_argument(f"--{name}", type=str)


def _apply_overrides(obj, overrides: dict[str, Any]):
    """Rebuild a dataclass tree with dotted-path overrides (None = unset)."""
    by_child: dict[str, dict] = {}
    changes = {}
    for k, v in overrides.items():
        if v is None:
            continue
        if "." in k:
            head, rest = k.split(".", 1)
            by_child.setdefault(head, {})[rest] = v
        else:
            changes[k] = v
    for head, sub in by_child.items():
        changes[head] = _apply_overrides(getattr(obj, head), sub)
    return dataclasses.replace(obj, **changes) if changes else obj


def _self_command() -> list[str]:
    """The command line that started this process's entry point."""
    spec = getattr(sys.modules["__main__"], "__spec__", None)
    if spec is not None:
        return [sys.executable, "-m", spec.name]
    return [sys.executable, sys.argv[0]]


def run_task_group(tasks: dict[str, Any], argv: list[str] | None = None) -> Any:
    """Each named preset becomes a subcommand whose dataclass fields are
    ``--dotted.path`` flags; returns what the configured task's ``run()``
    returns."""
    argv = sys.argv[1:] if argv is None else argv
    parser = argparse.ArgumentParser()
    parser.add_argument("--profiling", type=str, default=None)
    parser.add_argument("--trace", type=str, default=None)
    parser.add_argument("--auto-breakpoint", action="store_true")
    parser.add_argument("--detach", action="store_true")
    parser.add_argument("--detach-log", type=str, default="task-detached.log")
    parser.add_argument("--join-timeout", type=float, default=None)
    subs = parser.add_subparsers(dest="command", required=True)
    for name, task in tasks.items():
        _add_dataclass_args(subs.add_parser(name), type(task))
    args = vars(parser.parse_args(argv))
    command = args.pop("command")
    profiling = args.pop("profiling")
    trace = args.pop("trace")
    auto_bp = args.pop("auto_breakpoint")
    detach = args.pop("detach")
    detach_log = args.pop("detach_log")
    join_timeout = args.pop("join_timeout")
    task = _apply_overrides(tasks[command], args)

    if detach:
        import subprocess

        child_argv = [a for a in argv if a != "--detach"]
        with open(detach_log, "ab") as log:
            proc = subprocess.Popen(_self_command() + child_argv, stdout=log, stderr=log,
                                    start_new_session=True)
        print(f"detached as pid {proc.pid} (log: {detach_log})")
        return proc.pid
    if join_timeout is not None:
        import subprocess

        drop = ("--join-timeout", str(join_timeout))
        child_argv = [a for i, a in enumerate(argv)
                      if a not in drop and (i == 0 or argv[i - 1] != "--join-timeout")]
        proc = subprocess.Popen(_self_command() + child_argv)
        try:
            return proc.wait(timeout=join_timeout)
        except subprocess.TimeoutExpired:
            proc.terminate()
            proc.wait()
            raise TimeoutError(f"task exceeded --join-timeout {join_timeout}s and was terminated")

    def _run():
        if trace is None:
            return task.run()
        import torch

        with torch.profiler.profile() as prof:
            result = task.run()
        Path(trace).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(trace) / "trace.json"))
        return result

    try:
        if profiling is not None:
            import cProfile

            prof = cProfile.Profile()
            try:
                return prof.runcall(_run)
            finally:
                prof.dump_stats(profiling)
        return _run()
    except Exception:
        if auto_bp:
            import pdb
            import traceback

            traceback.print_exc()
            pdb.post_mortem()
        raise
