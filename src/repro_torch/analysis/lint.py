"""AST-based repo-specific lint rules (RA001-RA011) for the PyTorch port.

Port of ``src/repro/analysis/lint.py``: the same plumbing (``Finding``,
``Rule``, ``Module``, ``ra: allow`` suppression, ``lint_source``,
``lint_file``, ``lint_paths`` with allowlists, ``rule_catalog``) and the
same eleven codes.  RA001, RA002, RA006, RA007, RA008, RA009 and RA011 keep
the reference's logic and constants; their scopes match the port's package
(``src/repro_torch/``) where the reference's match ``src/repro/``.  Four
rules differ:

* **RA003** checks host code inside a CUDA-graph capture (the body of
  ``with torch.cuda.graph(...)`` and what is passed to
  ``torch.cuda.make_graphed_callables``) where the reference checks
  jit/Pallas-traced functions: host code there runs once, at capture, and
  replays repeat only the device work.  Host syncs, which capture forbids,
  are findings too.
* **RA004** checks that the module constants shaping a kernel launch
  (``SPLIT_KEYS``, ``HEAD_DIMS``, ``MAX_GROUP``, ``MAX_SPLIT_PAGES``) are
  bound once, to a literal, where the reference checks ``static_argnames``:
  the split plans are cached on shapes only, so a rebound constant serves
  stale plans.
* **RA005** adds torch's process-global RNG (``torch.manual_seed``, the
  samplers without ``generator=``) to the reference's numpy and ``random``
  checks, and scopes ``chip_smoke.py`` with src, benchmarks and examples.
* **RA010** checks the kernel wrappers' device guard where the reference
  checks ``pallas_call(interpret=...)``: a plain version runs only under
  ``if <tensor>.device.type == "cpu"``, a failed launch raises instead of
  falling back, and no wrapper defaults its mode keyword to a constant.

Each rule is proven by a good/bad fixture pair under
``repro_torch/analysis/fixtures/`` (``tests/test_torch_lint.py``), stored
as ``.py.txt`` so that no tree walk lints them as code.

Suppression: a finding whose source line carries ``ra: allow[RA00x]``
(or ``ra: allow`` for any rule) is dropped.  The port's tree must stay
clean without suppressions.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from pathlib import Path
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Set, Tuple)

# --------------------------------------------------------------- plumbing ---


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message}"


@dataclass(frozen=True)
class Rule:
    code: str
    title: str
    doc: str
    scope: Callable[[str], bool]
    check: Callable[["Module"], Iterable[Finding]]


class Module:
    """One parsed file plus the lookups the rules share."""

    def __init__(self, path: str, source: str):
        self.path = path.replace("\\", "/")
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self.parents: Dict[ast.AST, ast.AST] = {}
        for node in ast.walk(self.tree):
            for child in ast.iter_child_nodes(node):
                self.parents[child] = node
        # module/class-level function defs by name (for resolving
        # ``torch.cuda.make_graphed_callables(fn, ...)`` targets and the
        # kernel wrappers)
        self.defs: Dict[str, ast.FunctionDef] = {
            n.name: n for n in ast.walk(self.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        return Finding(rule, self.path, getattr(node, "lineno", 1),
                       getattr(node, "col_offset", 0), message)

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.parents.get(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                return cur
            cur = self.parents.get(cur)
        return None


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` → "a.b.c"; None for anything not a pure name chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _is_self(node: ast.AST) -> bool:
    return isinstance(node, ast.Name) and node.id in ("self", "cls")


def _scope_all(path: str) -> bool:
    return True


def _scope_src(path: str) -> bool:
    return "src/repro_torch/" in path or path.startswith("repro_torch/")


def _scope_deterministic(path: str) -> bool:
    """Code the port's numbers come from: src + benchmarks + examples +
    ``chip_smoke.py`` (tests may use their own randomness, e.g.
    hypothesis)."""
    return (_scope_src(path) or "benchmarks/" in path
            or "examples/" in path
            or path.rsplit("/", 1)[-1] == "chip_smoke.py")


# ------------------------------------------------------------------ RA001 ---

_SETTER_BACKED = ("_active_blocks", "_healthy", "_capacity")


def _check_ra001(m: Module) -> Iterable[Finding]:
    for node in ast.walk(m.tree):
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for tgt in targets:
            if (isinstance(tgt, ast.Attribute)
                    and tgt.attr in _SETTER_BACKED
                    and not _is_self(tgt.value)):
                yield m.finding(
                    "RA001", tgt,
                    f"direct write to `{tgt.attr}` bypasses the WorkerState "
                    f"property setter that invalidates the router's cached "
                    f"dense load vector; assign `{tgt.attr.lstrip('_')}` "
                    f"instead")


# ------------------------------------------------------------------ RA002 ---

_MEMO_METHODS = {"best_worker", "overlap_scores", "matched_blocks",
                 "on_schedule", "remove_worker_blocks", "select_worker"}
# `insert`/`route` are common names (list.insert, Flask-ish route);
# only count them against router/indexer/control-plane receivers.
_MEMO_METHODS_GUARDED = {"insert", "route"}
_MEMO_RECEIVERS = ("indexer", "router", "control")


def _binds_hashes(fn: ast.AST) -> bool:
    args = getattr(fn, "args", None)
    if args is not None:
        names = [a.arg for a in args.args + args.kwonlyargs
                 + args.posonlyargs]
        if "hashes" in names or "hs" in names:
            return True
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            continue
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name) and tgt.id in ("hashes", "hs"):
                    return True
        if isinstance(node, ast.Attribute) and node.attr == "hashes" \
                and isinstance(node.ctx, ast.Load):
            return True
    return False


def _check_ra002(m: Module) -> Iterable[Finding]:
    memo_fns: Dict[ast.AST, bool] = {}
    for node in ast.walk(m.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        name = node.func.attr
        if name in _MEMO_METHODS_GUARDED:
            recv = dotted(node.func.value) or ""
            if not any(r in recv for r in _MEMO_RECEIVERS):
                continue
        elif name not in _MEMO_METHODS:
            continue
        kw = {k.arg for k in node.keywords}
        if "hashes" in kw or None in kw:     # None == **kwargs passthrough
            continue
        fn = m.enclosing_function(node)
        if fn is None:
            continue
        if fn not in memo_fns:
            memo_fns[fn] = _binds_hashes(fn)
        if memo_fns[fn]:
            yield m.finding(
                "RA002", node,
                f"`{name}()` drops the per-request block-hash memo that is "
                f"in scope here; thread it through with `hashes=` so the "
                f"prompt is hashed once per request, not once per hop")


# ------------------------------------------------------------------ RA003 ---

_IMPURE_EXACT = {"time.time", "time.monotonic", "time.perf_counter",
                 "time.process_time", "time.sleep", "datetime.now",
                 "datetime.datetime.now", "os.urandom", "print", "input",
                 "id"}
_IMPURE_PREFIX = ("np.random.", "numpy.random.", "random.")
_MUTATORS = {"append", "extend", "add", "update", "pop", "popitem",
             "setdefault", "clear", "remove", "insert"}
# host syncs, which a capture forbids: each copies a device value to the host
_SYNC_METHODS = ("item", "cpu", "tolist", "numpy")
_SYNC_CALL = "torch.cuda.synchronize"
_GRAPH_CONTEXT = "torch.cuda.graph"
_GRAPHED_CALLABLES = "torch.cuda.make_graphed_callables"


def _captured_regions(m: Module) -> List[Tuple[List[ast.AST], Set[str]]]:
    """Code that runs under a CUDA-graph capture, each region with the names
    bound inside it: the body of ``with torch.cuda.graph(...)``, and the
    defs/lambdas passed to ``torch.cuda.make_graphed_callables`` (alone or
    in a tuple, incl. through ``functools.partial``)."""
    out: List[Tuple[List[ast.AST], Set[str]]] = []
    seen: Set[ast.AST] = set()

    def add(fn: Optional[ast.AST]) -> None:
        if fn is not None and fn not in seen:
            seen.add(fn)
            out.append(([fn], _local_bindings(fn)))

    def resolve(arg: ast.AST) -> None:
        if isinstance(arg, ast.Lambda):
            add(arg)
        elif isinstance(arg, ast.Name):
            add(m.defs.get(arg.id))
        elif isinstance(arg, (ast.Tuple, ast.List)):
            for el in arg.elts:
                resolve(el)
        elif isinstance(arg, ast.Call):      # functools.partial(fn, ...)
            name = dotted(arg.func)
            if name in ("functools.partial", "partial") and arg.args:
                resolve(arg.args[0])

    for node in ast.walk(m.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            if any(isinstance(it.context_expr, ast.Call)
                   and dotted(it.context_expr.func) == _GRAPH_CONTEXT
                   for it in node.items):
                out.append((list(node.body), _local_bindings(node)))
        elif isinstance(node, ast.Call) \
                and dotted(node.func) == _GRAPHED_CALLABLES and node.args:
            resolve(node.args[0])
    return out


def _local_bindings(fn: ast.AST) -> Set[str]:
    bound: Set[str] = set()
    args = getattr(fn, "args", None)
    if args is not None:
        for a in (args.args + args.kwonlyargs + args.posonlyargs):
            bound.add(a.arg)
        if args.vararg:
            bound.add(args.vararg.arg)
        if args.kwarg:
            bound.add(args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.add(node.id)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node is not fn:
            bound.add(node.name)
    return bound


def _check_ra003(m: Module) -> Iterable[Finding]:
    done: Set[ast.AST] = set()
    for roots, local in _captured_regions(m):
        for node in (n for root in roots for n in ast.walk(root)):
            if not isinstance(node, ast.Call) or node in done:
                continue
            done.add(node)
            name = dotted(node.func)
            if name is not None and (
                    name in _IMPURE_EXACT
                    or any(name.startswith(p) for p in _IMPURE_PREFIX)):
                yield m.finding(
                    "RA003", node,
                    f"impure call `{name}()` inside a CUDA-graph capture: "
                    f"host code runs once, at capture, and every replay "
                    f"repeats only the device work it recorded")
                continue
            if name == _SYNC_CALL or (
                    isinstance(node.func, ast.Attribute)
                    and node.func.attr in _SYNC_METHODS):
                what = name or f".{node.func.attr}"
                yield m.finding(
                    "RA003", node,
                    f"host sync `{what}()` inside a CUDA-graph capture: "
                    f"capture forbids reading the device from the host, "
                    f"and a value read there would be frozen into every "
                    f"replay")
                continue
            # container mutation: only bare statements (`xs.append(v)`) on
            # a name the captured code does not bind itself
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _MUTATORS
                    and isinstance(m.parents.get(node), ast.Expr)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id not in local):
                yield m.finding(
                    "RA003", node,
                    f"mutation `{node.func.value.id}.{node.func.attr}(...)` "
                    f"of an outside container inside a CUDA-graph capture: "
                    f"it happens once, at capture, and never on replay")


# ------------------------------------------------------------------ RA004 ---

# Module constants that shape a kernel launch.  The split plans are
# lru_cached on shapes only (kernels/*/ops.py `split_plan`), so a rebound
# constant serves the first call's plan; the chunk must also stay a
# multiple of the kernel's compile-time tile.
_KERNEL_CONSTANTS = ("SPLIT_KEYS", "HEAD_DIMS", "MAX_GROUP",
                     "MAX_SPLIT_PAGES")


def _loads_kernel(m: Module) -> bool:
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Call):
            name = dotted(node.func) or ""
            if name == "build.load" or name.endswith(".build.load"):
                return True
    return False


def _is_literal(node: Optional[ast.AST]) -> bool:
    if node is None:
        return False
    try:
        ast.literal_eval(node)
    except (ValueError, TypeError):
        return False
    return True


def _check_ra004(m: Module) -> Iterable[Finding]:
    if _loads_kernel(m):
        stores = sorted(
            (n for n in ast.walk(m.tree)
             if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Store)
             and n.id in _KERNEL_CONSTANTS),
            key=lambda n: (n.lineno, n.col_offset))
        bound: Set[str] = set()
        for node in stores:
            fn = m.enclosing_function(node)
            if fn is not None:
                where = f"inside `{getattr(fn, 'name', 'lambda')}`"
            else:
                stmt = m.parents.get(node)
                if node.id not in bound \
                        and isinstance(stmt, (ast.Assign, ast.AnnAssign)) \
                        and _is_literal(stmt.value):
                    bound.add(node.id)
                    continue
                where = "at module level a second time or not to a literal"
            yield m.finding(
                "RA004", node,
                f"kernel-shaping constant `{node.id}` is rebound {where}: "
                f"it must be assigned once, at module level, to a literal "
                f"(the split plans are cached on shapes only)")
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Attribute) and isinstance(node.ctx, ast.Store) \
                and node.attr in _KERNEL_CONSTANTS and not _is_self(node.value):
            yield m.finding(
                "RA004", node,
                f"`{dotted(node) or node.attr}` rebinds a kernel-shaping "
                f"constant from outside its module: launches after it run "
                f"with plans cached for the old value")
        elif isinstance(node, ast.Call) and len(node.args) > 1 \
                and (dotted(node.func) or "").endswith("setattr") \
                and isinstance(node.args[1], ast.Constant) \
                and node.args[1].value in _KERNEL_CONSTANTS:
            yield m.finding(
                "RA004", node,
                f"`{dotted(node.func)}(..., {node.args[1].value!r}, ...)` "
                f"rebinds a kernel-shaping constant at runtime: launches "
                f"after it run with plans cached for the old value")


# ------------------------------------------------------------------ RA005 ---

_NP_SAMPLERS = {"seed", "rand", "randn", "randint", "random", "choice",
                "shuffle", "permutation", "normal", "uniform", "poisson",
                "exponential", "lognormal", "standard_normal"}
_PY_SAMPLERS = {"random", "randint", "randrange", "choice", "choices",
                "shuffle", "sample", "uniform", "gauss", "betavariate",
                "seed"}
_TORCH_SEED = "torch.manual_seed"
_TORCH_SAMPLERS = ("rand", "randn", "randint", "randperm", "normal",
                   "bernoulli", "multinomial")
_TORCH_INPLACE_SAMPLERS = ("uniform_", "normal_", "random_", "exponential_",
                           "bernoulli_")


def _torch_global_rng(node: ast.Call, name: Optional[str]) -> Optional[str]:
    """The finding's message if ``node`` seeds or draws from torch's
    process-global generator, else None."""
    if name == _TORCH_SEED:
        return (f"`{name}()` seeds torch's process-global generator: every "
                f"draw in the process then depends on call order; pass a "
                f"`torch.Generator(...).manual_seed(seed)` as `generator=`")
    if any(k.arg in ("generator", None) for k in node.keywords):
        return None
    parts = (name or "").split(".")
    if len(parts) == 2 and parts[0] == "torch" and parts[1] in _TORCH_SAMPLERS:
        what = name
    elif isinstance(node.func, ast.Attribute) \
            and node.func.attr in _TORCH_INPLACE_SAMPLERS:
        what = f".{node.func.attr}"
    else:
        return None
    return (f"`{what}()` without `generator=` draws from torch's "
            f"process-global generator; pass a seeded `torch.Generator`")


def _check_ra005(m: Module) -> Iterable[Finding]:
    for node in ast.walk(m.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name is None:
            msg = _torch_global_rng(node, name)
            if msg:
                yield m.finding("RA005", node, msg)
            continue
        if name in ("random.Random", "np.random.default_rng",
                    "numpy.random.default_rng") \
                and not node.args and not node.keywords:
            yield m.finding(
                "RA005", node,
                f"`{name}()` without a seed draws OS entropy: routing/"
                f"eviction decisions fed from it are unreproducible — pass "
                f"an explicit seed")
            continue
        parts = name.split(".")
        if len(parts) >= 3 and parts[-3] in ("np", "numpy") \
                and parts[-2] == "random" and parts[-1] in _NP_SAMPLERS:
            yield m.finding(
                "RA005", node,
                f"`{name}()` uses numpy's process-global RNG state; use a "
                f"seeded `np.random.default_rng(seed)` stream instead")
        elif len(parts) == 2 and parts[0] == "random" \
                and parts[1] in _PY_SAMPLERS:
            yield m.finding(
                "RA005", node,
                f"`{name}()` uses the process-global `random` module state; "
                f"use a seeded `random.Random(seed)` instance instead")
        else:
            msg = _torch_global_rng(node, name)
            if msg:
                yield m.finding("RA005", node, msg)


# ------------------------------------------------------------------ RA006 ---


def _is_set_expr(node: ast.AST) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return dotted(node.func) in ("set", "frozenset")
    return False


def _check_ra006(m: Module) -> Iterable[Finding]:
    def hit(node: ast.AST) -> Finding:
        return m.finding(
            "RA006", node,
            "iterating a set: CPython set order is insertion-history- and "
            "hash-seed-dependent, so anything downstream (routing, "
            "eviction, event order) loses determinism — sort it first "
            "(`sorted(...)`)")

    for node in ast.walk(m.tree):
        if isinstance(node, (ast.For, ast.AsyncFor)) \
                and _is_set_expr(node.iter):
            yield hit(node.iter)
        elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp,
                               ast.GeneratorExp)):
            for gen in node.generators:
                if _is_set_expr(gen.iter):
                    yield hit(gen.iter)
        elif isinstance(node, ast.Call):
            name = dotted(node.func)
            if name in ("list", "tuple", "enumerate", "iter") and node.args \
                    and _is_set_expr(node.args[0]):
                yield hit(node.args[0])


# ------------------------------------------------------------------ RA007 ---

# Load-bearing private state and the one module allowed to touch it.
_PRIVATE_OWNERS = {
    "_state_cache": "core/router.py",       # router's dense load cache
    "_node_by_hash": "core/radix.py",       # radix lookup table
    "_worker_blocks": "core/radix.py",      # radix claim counters
    "_resident": "serving/engine.py",       # decode-worker residency LRU
    "_prefill": "serving/engine.py",        # jitted prompt pass
    "_resume": "serving/engine.py",         # jitted resume pass
    "_best_match": "serving/engine.py",     # prefix-cache walk (LRU-mutating)
    "_template_cache": "serving/simulator.py",
}


def _check_ra007(m: Module) -> Iterable[Finding]:
    for node in ast.walk(m.tree):
        if not isinstance(node, ast.Attribute):
            continue
        owner = _PRIVATE_OWNERS.get(node.attr)
        if owner is None or m.path.endswith(owner) or _is_self(node.value):
            continue
        yield m.finding(
            "RA007", node,
            f"`{node.attr}` is private coherence-critical state of "
            f"`repro_torch/{owner.rsplit('.', 1)[0].replace('/', '.')}"
            f"{''}`; mutating or reading it cross-module bypasses the "
            f"invariants its owner maintains — use the public API")


# ------------------------------------------------------------------ RA008 ---


def _check_ra008(m: Module) -> Iterable[Finding]:
    pins: List[ast.Call] = []
    releases = 0
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in ("pin", "admit_blocks"):
                pins.append(node)
            elif node.func.attr in ("unpin", "free"):
                releases += 1
    if pins and not releases:
        yield m.finding(
            "RA008", pins[0],
            "this module pins KV blocks (`pin`/`admit_blocks`) but never "
            "releases them (`unpin`/`free`): leaked pins make blocks "
            "permanently ineviction-proof and drive G1 into the "
            "over-subscribed regime for the wrong reason")


# ------------------------------------------------------------------ RA009 ---

# Modules that run on the simulated event clock (`now`), where a wall-clock
# read breaks replay determinism.
_EVENT_CLOCK_MODULES = (
    "serving/simulator.py", "serving/workload.py", "core/radix.py",
    "core/router.py", "core/kvbm.py", "core/poa.py", "core/saturation.py",
    "core/planner.py", "core/metrics.py", "core/games.py",
)

_WALL_CLOCK = {"time.time", "time.monotonic", "time.perf_counter",
               "time.process_time", "time.sleep", "datetime.now",
               "datetime.datetime.now"}


def _scope_event_clock(path: str) -> bool:
    return any(path.endswith(mod) for mod in _EVENT_CLOCK_MODULES)


def _check_ra009(m: Module) -> Iterable[Finding]:
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Call) and dotted(node.func) in _WALL_CLOCK:
            yield m.finding(
                "RA009", node,
                f"wall-clock read `{dotted(node.func)}()` in an event-clock "
                f"module: the analytic plane is replay-deterministic only "
                f"if every timestamp derives from the simulated `now`")


# ------------------------------------------------------------------ RA010 ---

# The port's kernel wrappers (kernels/*/ops.py); a def that counts its own
# launches (``<name>.launches += 1``) is one too.
_KERNEL_WRAPPERS = ("decode_attention", "paged_attention", "flash_attention")
_MODE_KWARGS = ("use_kernel", "plain", "fallback", "interpret")


def _counts_own_launches(fn: ast.AST) -> bool:
    name = getattr(fn, "name", None)
    return any(isinstance(n, ast.AugAssign)
               and isinstance(n.target, ast.Attribute)
               and n.target.attr == "launches"
               and dotted(n.target.value) == name
               for n in ast.walk(fn))


def _launcher_call(name: Optional[str]) -> bool:
    return name is not None and (name.endswith("_launcher")
                                 or name == "build.load"
                                 or name.endswith(".build.load"))


def _launch_names(fn: Optional[ast.AST]) -> Set[str]:
    """Names ``fn`` binds from a ``*_launcher()`` call (``lib, fn =
    _launcher()``): calling one launches a kernel."""
    out: Set[str] = set()
    if fn is None:
        return out
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and _launcher_call(dotted(node.value.func)):
            for tgt in node.targets:
                for el in ast.walk(tgt):
                    if isinstance(el, ast.Name):
                        out.add(el.id)
    return out


def _plain_call(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) \
        and (dotted(node.func) or "").endswith("_plain")


def _cpu_test(test: ast.AST) -> bool:
    """``<x>.device.type == "cpu"``, alone or as a term of an ``and``."""
    if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.And):
        return any(_cpu_test(v) for v in test.values)
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        return False
    sides = (test.left, test.comparators[0])
    return any(isinstance(a, ast.Attribute) and a.attr == "type"
               and isinstance(a.value, ast.Attribute)
               and a.value.attr == "device"
               and isinstance(b, ast.Constant) and b.value == "cpu"
               for a, b in (sides, sides[::-1]))


def _cpu_guarded(m: Module, node: ast.AST) -> bool:
    child, cur = node, m.parents.get(node)
    while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        if isinstance(cur, ast.If) and child in cur.body \
                and _cpu_test(cur.test):
            return True
        child, cur = cur, m.parents.get(cur)
    return False


def _enclosing_def(m: Module, node: ast.AST) -> Optional[ast.AST]:
    cur = m.enclosing_function(node)
    while isinstance(cur, ast.Lambda):
        cur = m.enclosing_function(cur)
    return cur


def _check_ra010(m: Module) -> Iterable[Finding]:
    wrappers = set(_KERNEL_WRAPPERS) | {
        fn.name for fn in m.defs.values() if _counts_own_launches(fn)}
    fallbacks: Set[ast.AST] = set()
    for node in ast.walk(m.tree):
        if isinstance(node, ast.Try):
            launches = _launch_names(_enclosing_def(m, node))
            calls = [n for stmt in node.body for n in ast.walk(stmt)
                     if isinstance(n, ast.Call)]
            if not any(_launcher_call(dotted(c.func))
                       or (dotted(c.func) or "").rsplit(".", 1)[-1] in wrappers
                       or (isinstance(c.func, ast.Name)
                           and c.func.id in launches) for c in calls):
                continue
            for handler in node.handlers:
                inner = list(ast.walk(handler))
                if any(_plain_call(n) for n in inner):
                    what = "falls back to the plain version"
                elif any(isinstance(n, ast.Return) for n in inner) \
                        or not any(isinstance(n, ast.Raise) for n in inner):
                    what = "returns instead of raising"
                else:
                    continue
                fallbacks.add(handler)
                yield m.finding(
                    "RA010", handler,
                    f"a failed kernel launch {what}: a CUDA tensor launches "
                    f"the kernel or raises, so a broken kernel cannot pass "
                    f"as the plain path")
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and (node.name in wrappers or _counts_own_launches(node)):
            args = node.args
            positional = args.posonlyargs + args.args
            pairs = list(zip(positional[len(positional)
                                        - len(args.defaults):],
                             args.defaults))
            pairs += list(zip(args.kwonlyargs, args.kw_defaults))
            for arg, dflt in pairs:
                if arg.arg in _MODE_KWARGS and isinstance(dflt, ast.Constant) \
                        and dflt.value is not None:
                    yield m.finding(
                        "RA010", node,
                        f"kernel wrapper `{node.name}` defaults "
                        f"`{arg.arg}={dflt.value!r}`: the mode must follow "
                        f"the tensor's device (plain on the CPU, the kernel "
                        f"on CUDA), not a default")
    for node in ast.walk(m.tree):
        if not _plain_call(node) or _cpu_guarded(m, node):
            continue
        fn = _enclosing_def(m, node)
        if fn is not None and fn.name.endswith("_plain"):
            continue
        cur = m.parents.get(node)
        while cur is not None and cur not in fallbacks:
            cur = m.parents.get(cur)
        if cur is not None:
            continue                    # reported as a fallback above
        yield m.finding(
            "RA010", node,
            f"`{dotted(node.func)}()` outside an `if <tensor>.device.type "
            f"== \"cpu\"` guard: the plain version is the CPU path only, "
            f"and a CUDA tensor must launch the kernel or raise")


# ------------------------------------------------------------------ RA011 ---

# Authoritative control-plane state a replica-side view may only read at
# sync time (ReplicaStateView.sync) — between syncs every read must come
# from the view's own frozen snapshot fields.
_AUTHORITATIVE_ATTRS = {"router", "indexer", "detector", "policy",
                        "workers", "dual", "planner", "poa"}
_RA011_CLASS_RE = None  # compiled lazily (re import kept local to the rule)


def _replica_view_class(name: str) -> bool:
    global _RA011_CLASS_RE
    if _RA011_CLASS_RE is None:
        import re
        _RA011_CLASS_RE = re.compile(r"^Replica\w*View$")
    return bool(_RA011_CLASS_RE.match(name))


def _enclosing_method_name(m: Module, node: ast.AST,
                           cls: ast.ClassDef) -> Optional[str]:
    cur = m.parents.get(node)
    name = None
    while cur is not None and cur is not cls:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            name = cur.name
        cur = m.parents.get(cur)
    return name


def _check_ra011(m: Module) -> Iterable[Finding]:
    for cls in ast.walk(m.tree):
        if not (isinstance(cls, ast.ClassDef)
                and _replica_view_class(cls.name)):
            continue
        for node in ast.walk(cls):
            if not isinstance(node, ast.Attribute):
                continue
            meth = _enclosing_method_name(m, node, cls)
            if meth == "sync":
                continue               # the one sanctioned authoritative read
            if node.attr == "_plane" and meth not in (None, "__init__"):
                yield m.finding(
                    "RA011", node,
                    f"replica view method `{meth}` reaches through "
                    f"`_plane` to live control-plane state: between syncs "
                    f"a replica may only read its own frozen snapshot "
                    f"fields (move the read into `sync()`)")
            elif node.attr in _AUTHORITATIVE_ATTRS \
                    and not _is_self(node.value):
                where = f"method `{meth}`" if meth else "class body"
                yield m.finding(
                    "RA011", node,
                    f"replica view {where} reads authoritative "
                    f"control-plane state `.{node.attr}` directly; "
                    f"replica-side code must route reads through the "
                    f"StateView snapshot (populate it in `sync()`)")


# ----------------------------------------------------------------- catalog --

RULES: List[Rule] = [
    Rule("RA001", "setter-bypassing WorkerState mutation",
         "Writes to `_active_blocks`/`_healthy`/`_capacity` on anything "
         "but `self` skip the property setters that invalidate the "
         "router's cached dense load vector — the router then routes on a "
         "stale view, which changes the measured game, not just speed.",
         _scope_all, _check_ra001),
    Rule("RA002", "dropped block-hash memo on a hot-path call",
         "Router/indexer entry points accept a `hashes=` memo so each "
         "request's chained block hashes are computed once.  A call that "
         "drops the memo while one is in scope silently re-hashes the "
         "prompt per hop (the pre-PR-4 hot-path regression).",
         _scope_src, _check_ra002),
    Rule("RA003", "impure host code inside a CUDA-graph capture",
         "Capture records device work only: wall clocks, global RNG, "
         "`print` and mutation of outside containers run once, at capture, "
         "and replays never repeat them; a host sync (`.item()`, `.cpu()`, "
         "`.tolist()`, `.numpy()`, `torch.cuda.synchronize()`) is "
         "forbidden during capture and would freeze its value into every "
         "replay.",
         _scope_all, _check_ra003),
    Rule("RA004", "kernel-shaping constant rebound at runtime",
         "`SPLIT_KEYS`/`HEAD_DIMS`/`MAX_GROUP`/`MAX_SPLIT_PAGES` shape the "
         "kernels' launches and are bound once, at module level, to a "
         "literal; the split plans are cached on shapes only, so a "
         "rebinding (in a function, through `global`, `<module>.NAME = "
         "...` or `monkeypatch.setattr`) serves stale plans, and a chunk "
         "off the kernel's tile breaks the launch.",
         _scope_all, _check_ra004),
    Rule("RA005", "unseeded / process-global RNG",
         "Every stochastic choice that feeds routing, eviction, workload "
         "sampling or a weight draw must come from an explicitly seeded "
         "stream (a numpy `default_rng(seed)`, a `random.Random(seed)`, a "
         "`torch.Generator` passed as `generator=`); OS entropy and "
         "process-global state (`torch.manual_seed` included) make runs "
         "unreproducible and bit-exactness pins meaningless.",
         _scope_deterministic, _check_ra005),
    Rule("RA006", "iteration over an unordered set",
         "Set iteration order depends on insertion history and the "
         "per-process hash seed: any routing or eviction decision "
         "downstream of it is nondeterministic.  Sort before iterating.",
         _scope_src, _check_ra006),
    Rule("RA007", "cross-module access to coherence-critical private state",
         "`_state_cache`, `_node_by_hash`, `_worker_blocks`, the engine's "
         "jitted callables and caches: their owners maintain invariants "
         "on every mutation.  Touching them from another module bypasses "
         "those invariants (use the public API / audit hooks).",
         _scope_src, _check_ra007),
    Rule("RA008", "KV pins acquired but never released",
         "A module that pins blocks (`pin`/`admit_blocks`) without any "
         "release path (`unpin`/`free`) leaks refcounts: pinned blocks "
         "are eviction-proof, so the leak drives G1 over capacity "
         "permanently.",
         _scope_src, _check_ra008),
    Rule("RA009", "wall-clock read in an event-clock module",
         "The analytic simulator and the core game mechanisms run on the "
         "simulated clock; a `time.*` read there breaks replay "
         "determinism and couples results to host speed.",
         _scope_event_clock, _check_ra009),
    Rule("RA010", "kernel wrapper's device guard missing, or a fallback",
         "A kernel wrapper takes its plain version only for a CPU tensor "
         "(under `if <tensor>.device.type == \"cpu\"`) and launches the "
         "kernel for a CUDA tensor or raises: a plain call outside that "
         "guard, a `try` whose handler falls back to the plain version or "
         "returns, or a mode keyword defaulted to a constant lets a broken "
         "or missing kernel pass silently as the plain path.",
         _scope_src, _check_ra010),
    Rule("RA011", "replica-side read of authoritative control-plane state",
         "`Replica*View` classes are bounded-staleness snapshots: only "
         "`sync()` may read the plane's live router/indexer/detector "
         "state.  Any other method reaching through `_plane` (or stashing "
         "a live `.router`/`.indexer`/... reference) silently reintroduces "
         "fresh reads, and the measured staleness externality becomes a "
         "lie.",
         _scope_all, _check_ra011),
]

_RULES_BY_CODE = {r.code: r for r in RULES}


def rule_catalog() -> str:
    out = []
    for r in RULES:
        out.append(f"{r.code}  {r.title}")
        out.append(f"       {r.doc}")
    return "\n".join(out)


# ------------------------------------------------------------------ runner --

_ALLOW_TOKEN = "ra: allow"


def _suppressed(m: Module, f: Finding) -> bool:
    if not 1 <= f.line <= len(m.lines):
        return False
    line = m.lines[f.line - 1]
    idx = line.find(_ALLOW_TOKEN)
    if idx < 0:
        return False
    rest = line[idx + len(_ALLOW_TOKEN):]
    if not rest.lstrip().startswith("["):
        return True                                   # blanket allow
    codes = rest.lstrip()[1:].split("]", 1)[0]
    return f.rule in {c.strip() for c in codes.split(",")}


def lint_source(path: str, source: str,
                select: Optional[Sequence[str]] = None) -> List[Finding]:
    m = Module(path, source)
    findings: List[Finding] = []
    for rule in RULES:
        if select is not None and rule.code not in select:
            continue
        if not rule.scope(m.path):
            continue
        findings.extend(f for f in rule.check(m) if not _suppressed(m, f))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def lint_file(path, select: Optional[Sequence[str]] = None) -> List[Finding]:
    p = Path(path)
    return lint_source(str(p), p.read_text(), select=select)


_SKIP_DIRS = {"__pycache__", ".git", ".ruff_cache", "node_modules"}
# the lint pass never scans a violation corpus, the reference's or its own
_FIXTURES = ("repro/analysis/fixtures", "repro_torch/analysis/fixtures")


def iter_python_files(paths: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for root in paths:
        p = Path(root)
        if p.is_file() and p.suffix == ".py":
            out.append(p)
            continue
        for f in sorted(p.rglob("*.py")):
            rel = f.as_posix()
            if any(part in _SKIP_DIRS for part in f.parts):
                continue
            if any(fx in rel for fx in _FIXTURES):
                continue
            out.append(f)
    return out


def lint_paths(paths: Sequence[str],
               select: Optional[Sequence[str]] = None,
               allowlist: Sequence[str] = ()) -> List[Finding]:
    """Lint every .py file under ``paths``.  ``allowlist`` entries are
    ``"RULE path-substring"`` pairs (one per line in the CLI's
    ``--allowlist`` file); a matching finding is dropped."""
    allow = []
    for entry in allowlist:
        entry = entry.strip()
        if not entry or entry.startswith("#"):
            continue
        rule, _, frag = entry.partition(" ")
        allow.append((rule, frag.strip()))
    findings: List[Finding] = []
    for f in iter_python_files(paths):
        for fd in lint_file(f, select=select):
            if any(fd.rule == rule and frag and frag in fd.path
                   for rule, frag in allow):
                continue
            findings.append(fd)
    return findings
