"""Pass 1 — AST kernel-contract linter (rules KC102, KC103, KC105–KC107),
the port of ``repro.analysis.contracts`` restated for the CUDA kernels.

Enforces the launch-plane conventions the wrappers already follow, so a
new wrapper (or a refactor of an old one) cannot quietly drop them. A
*library handle* is a name bound to a loaded kernel library: the result
of ``cuda.library(...)``, of a module function that returns one (such as
``_a1_mapc_lib``), of a ``lib_of()`` callback, or a parameter named
``lib``. A *launch* is a call into a handle — ``lib.fn(...)`` or
``getattr(lib, name)(...)`` — other than ``kernel_error_string``.

  KC102  a function that launches without a ``record_launch`` in the same
         function (as ``kernels/a1_count.py::_launch`` has). Untallied
         launches make ``tally.launch_counts()`` lie, and the chip runs
         read it to prove which kernels a path ran.
  KC103  carried state not advanced in place: a launch handed the
         ``data_ptr()`` of a temporary (``s.contiguous().data_ptr()``:
         the kernel advances a copy), or a ``copy_`` after the launch in
         the same function (the state rebuilt and copied back). The
         CUDA kernels read the state at their start and write it back at
         their end, which stands in for the Pallas calls'
         ``input_output_aliases``.
  KC105  an ``except`` arm in ``kernels/`` or ``core/`` around a launch or
         a kernel wrapper that runs a plain version (a ``*_plain``
         call). A CUDA tensor launches its kernel or raises; the plain
         version runs only for CPU tensors.
  KC106  a read of a ``REPRO_*`` opt-in from the environment
         (``os.environ[...]``, ``os.environ.get``, ``os.getenv``; by
         literal or by an ``ENV_*`` constant) outside the module that owns
         them, ``core/calibrate.py``: one accessor per variable, as the
         reference's one interpret accessor.
  KC107  a write to the launch-tally families (``kernel_launches``,
         ``plain_calls``, ``kernel_lanes``, ``plain_lanes``: a
         ``counter``/``gauge``/``histogram`` or ``clear_family`` call
         naming one) outside ``kernels/tally.py``, which owns them.

The reference's KC101 (a literal ``interpret=`` at a call site) and KC104
(a literal ``pl.BlockSpec`` shape) have no analogue here: a CUDA kernel
has no interpret mode (a CPU tensor runs the plain version), and its
launch geometry is fixed in its source (``analysis.vmem`` mirrors it).
Their ids are not reused.

``lint_source`` lints one snippet (used by the analyzer's own tests);
``lint_tree`` walks a source root and applies ``# audit-ok:`` markers.
Nothing here imports the code it audits.
"""

from __future__ import annotations

import ast
import pathlib

from .findings import Finding, split_suppressed

# the kernel wrappers whose failure an except arm must not paper over
# (KC105): every launching entry point of kernels/a1_count.py and
# kernels/a2_count.py, and the ops-level calls over them
KERNEL_WRAPPERS = frozenset({
    "a1_count_state", "a2_count_state", "a1_count_kernel",
    "a2_count_kernel", "a1_count_state_lanes", "a2_count_state_lanes",
    "a1_mapconcat_kernel", "a2_mapconcat_kernel", "a1_mapconcat_lanes",
    "a1_mapconcat_sharded", "a2_mapconcat_sharded",
    "a1_mapconcat_sharded_lanes", "mapc_launch", "mapc_call",
    "a1_state_call", "a2_state_call", "a1_mapc_vmapped",
    "a1_state_vmapped", "a2_state_vmapped", "a1_mapc_sharded_vmapped",
})
NO_LAUNCH = frozenset({"kernel_error_string"})
# KC105 applies under these directories
PLAIN_GUARDED_DIRS = ("kernels/", "core/")
ENV_OWNER_MODULE = "core/calibrate.py"
ENV_PREFIX = "REPRO_"
TALLY_MODULE = "kernels/tally.py"
# the registry families kernels/tally.py owns; KC107 rejects other writers
TALLY_FAMILIES = frozenset({"kernel_launches", "plain_calls",
                            "kernel_lanes", "plain_lanes"})


def _call_name(node: ast.Call) -> str:
    """Trailing name of the called object (``cuda.library`` -> library)."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _const_str(node) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _library_factories(tree) -> set[str]:
    """Module functions that return a loaded library (``return
    cuda.library(...)``)."""
    out = set()
    for fn in ast.walk(tree):
        if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for n in ast.walk(fn):
                if (isinstance(n, ast.Return)
                        and isinstance(n.value, ast.Call)
                        and _call_name(n.value) == "library"):
                    out.add(fn.name)
    return out


def _handles(fn, factories) -> set[str]:
    """Names bound to a library handle in ``fn`` (see the module doc)."""
    out = {a.arg for a in fn.args.args + fn.args.kwonlyargs
           if a.arg == "lib"}
    for n in ast.walk(fn):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)
                and len(n.targets) == 1
                and isinstance(n.targets[0], ast.Name)):
            callee = _call_name(n.value)
            if callee == "library" or callee in factories or \
                    callee == "lib_of":
                out.add(n.targets[0].id)
    return out


def _launches(fn, handles) -> list[ast.Call]:
    """The calls into a handle in ``fn`` (see the module doc)."""
    out = []
    for n in ast.walk(fn):
        if not isinstance(n, ast.Call):
            continue
        f = n.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id in handles and f.attr not in NO_LAUNCH):
            out.append(n)
        elif (isinstance(f, ast.Call) and _call_name(f) == "getattr"
              and f.args and isinstance(f.args[0], ast.Name)
              and f.args[0].id in handles):
            out.append(n)
    return sorted(out, key=lambda n: n.lineno)


def _calls(tree, name: str) -> list[ast.Call]:
    return [n for n in ast.walk(tree)
            if isinstance(n, ast.Call) and _call_name(n) == name]


def _temporary_data_ptr(call: ast.Call) -> ast.Call | None:
    """A ``<call>.data_ptr()`` among a launch's arguments: the pointer of
    a tensor made for the launch, not the caller's."""
    for n in ast.walk(call):
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "data_ptr"
                and isinstance(n.func.value, ast.Call)):
            return n
    return None


def _is_os_environ(node) -> bool:
    return (isinstance(node, ast.Attribute) and node.attr == "environ"
            and isinstance(node.value, ast.Name) and node.value.id == "os")


def _env_key(node) -> str | None:
    """The variable an environment read names, if it is a ``REPRO_*``
    literal or an ``ENV_*`` constant (by its name)."""
    s = _const_str(node)
    if s is not None:
        return s if s.startswith(ENV_PREFIX) else None
    name = (node.id if isinstance(node, ast.Name) else
            node.attr if isinstance(node, ast.Attribute) else "")
    return name if name.startswith("ENV_") else None


def _plain_in_handler(handler: ast.ExceptHandler) -> ast.Call | None:
    for n in ast.walk(ast.Module(body=handler.body, type_ignores=[])):
        if isinstance(n, ast.Call) and _call_name(n).endswith("_plain"):
            return n
    return None


def lint_source(source: str, path: str) -> list[Finding]:
    """Lint one module's source. Returns raw findings (no suppression —
    ``lint_tree`` applies the ``# audit-ok`` markers)."""
    tree = ast.parse(source, filename=path)
    findings: list[Finding] = []
    posix = pathlib.PurePosixPath(path).as_posix()
    in_env_owner = posix.endswith(ENV_OWNER_MODULE)
    in_tally = posix.endswith(TALLY_MODULE)
    guarded = any(f"/{d}" in f"/{posix}" for d in PLAIN_GUARDED_DIRS)
    factories = _library_factories(tree)
    funcs = [n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    for fn in funcs:
        handles = _handles(fn, factories)
        launches = _launches(fn, handles)
        if not launches:
            continue
        # KC102 — a launch without a tally in the same function
        if not _calls(fn, "record_launch"):
            findings.append(Finding(
                "KC102", path, launches[0].lineno,
                f"{fn.name}() launches a CUDA kernel without a "
                "record_launch in the same function"))
        # KC103 — state passed as a temporary, or copied back
        for call in launches:
            tmp = _temporary_data_ptr(call)
            if tmp is not None:
                findings.append(Finding(
                    "KC103", path, tmp.lineno,
                    f"{fn.name}() hands a launch the data_ptr() of a "
                    "temporary tensor — the kernel advances a copy"))
        first = launches[0].lineno
        for n in _calls(fn, "copy_"):
            if n.lineno > first:
                findings.append(Finding(
                    "KC103", path, n.lineno,
                    f"{fn.name}() copies a tensor back after its launch "
                    "— carried state is advanced in place"))

    module_handles = set().union(*(_handles(fn, factories)
                                   for fn in funcs))
    for node in ast.walk(tree):
        # KC105 — a plain version run after a failed launch
        if guarded and isinstance(node, ast.Try):
            body = ast.Module(body=node.body, type_ignores=[])
            launches = _launches(body, module_handles)
            wrapped = [n for n in ast.walk(body) if isinstance(n, ast.Call)
                       and _call_name(n) in KERNEL_WRAPPERS]
            if launches or wrapped:
                for h in node.handlers:
                    plain = _plain_in_handler(h)
                    if plain is not None:
                        findings.append(Finding(
                            "KC105", path, h.lineno,
                            f"except arm runs {_call_name(plain)}() after "
                            "a CUDA launch failed — a CUDA tensor launches "
                            "its kernel or raises"))

        # KC106 — an environment read of a REPRO_* opt-in outside its owner
        if not in_env_owner:
            key = None
            if (isinstance(node, ast.Subscript) and _is_os_environ(node.value)
                    and isinstance(node.ctx, ast.Load)):
                key = _env_key(node.slice)
            elif isinstance(node, ast.Call) and node.args and (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr == "get"
                    and _is_os_environ(node.func.value)
                    or _call_name(node) == "getenv"):
                key = _env_key(node.args[0])
            if key is not None:
                findings.append(Finding(
                    "KC106", path, node.lineno,
                    f"environment read of {key} — the REPRO_* opt-ins are "
                    f"read only in {ENV_OWNER_MODULE}"))

        # KC107 — a write to the launch tally outside kernels/tally.py
        if not in_tally and isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in ("counter", "gauge", "histogram",
                                   "clear_family") and node.args and \
                _const_str(node.args[0]) in TALLY_FAMILIES:
            findings.append(Finding(
                "KC107", path, node.lineno,
                f"direct registry write to the "
                f"{_const_str(node.args[0])!r} family — the launch tally "
                "is owned by kernels.tally (record_launch / record_plain "
                "/ reset_counts)"))

    return findings


def lint_tree(root) -> tuple[list[Finding], list[Finding], dict]:
    """Lint every ``*.py`` under ``root``.

    Returns (active findings, suppressed findings, summary dict); paths
    in findings are relative to ``root``'s parent so reports read like
    ``repro_torch/kernels/...``.
    """
    root = pathlib.Path(root)
    findings: list[Finding] = []
    sources: dict[str, list[str]] = {}
    n_files = 0
    for py in sorted(root.rglob("*.py")):
        rel = py.relative_to(root.parent).as_posix()
        text = py.read_text()
        sources[rel] = text.splitlines()
        findings.extend(lint_source(text, rel))
        n_files += 1
    active, waived = split_suppressed(findings, sources)
    return active, waived, {"files_linted": n_files}
