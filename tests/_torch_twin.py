"""Every case of a JAX-package test file, run in both packages and
compared: the port's counterparts of tests/test_filer*.py,
test_metaha.py, test_*_grpc.py, test_shell_fs_security.py,
test_configure_notify.py, and the gateway, replication and queue files
(test_s3*.py, test_streaming_upload.py, test_webdav.py,
test_messaging.py, test_query.py, test_mount.py, test_replication*.py,
test_kafka_queue.py, test_pubsub_queue.py, and the gateway cases of
test_tier.py, test_tenancy.py and test_cli.py), and of the robustness,
host, codec, coder, roofline, observability and profiling suites (the
test_torch_*_twins.py files).

`TwinFile("test_filer.py")` reads that file and compiles two copies of
it: the JAX package's as written, and the port's, with every name of
the JAX package (`seaweedfs_tpu`) replaced by the port's
(`seaweedfs_tpu_torch`).  In both copies every `assert` is rewritten to
record what it compares before it asserts as before, and pytest's
fixture, parametrize and skipif decorators are replaced by markers this
module resolves itself (a case the reference's skipif skips is skipped
in both packages).  `cases` lists every case pytest would collect from the
file (a test over a parametrised fixture or under `parametrize` gives
one case per value, as pytest's ids name them); `run(case_id, tmp_path)`
runs the case in the JAX package's copy and then in the port's, each in
a directory of its own with `random` and numpy's global generator
seeded alike, requires both to pass, and requires the two records to be
equal, assert by assert.  A half that fails carries a note naming it
("failed in the port's half"), which the test's report shows.

What an assert records: for `a == b` and `a != b` both operands; for
`a in b` and `a not in b` the left operand and the outcome; for any other
test its truth value.  Fixtures: `tmp_path`, `tmp_path_factory`,
`monkeypatch`, `request` (`param`, `addfinalizer`) and the file's own,
each built anew for each case and package (a module-scoped fixture too).
A test file that imports another (`from test_filer_server import ...`)
gets that file's copy of the same package.  In the port's copy the
volume server and the shell default to `device="cpu"`: the port's
default is the card, which this host lacks.  Ids drawn from
`secrets.token_hex` (hard-link ids) come from the seeded `random`
during a run, alike in both packages, and so do the bytes the test
file itself draws from `os.urandom` (its `import os`, at any depth, is
the twin's); file-id cookies and volume picks, and trace and span ids,
draw from seeded streams of their own (`seed_placement`, `_SeededOs`).
The process-wide counters and histograms that reference cases read as
absolute values (`FRESH_COUNTERS`, `FRESH_HISTOGRAMS`) start empty in
each package's half, and hold the process's values again after it.
An assert on a thread other than the case's own is compared as one of
a set: how often such a thread loops, and how its asserts interleave
with the case's, is the scheduler's.  A case whose test holds no assert
passes by passing in both packages.  A case may run after others on
the same fixtures (`prelude`), where the file's module-scoped fixture
carries state from one case to the next; and the port's copy of the
source may take (text, replacement) edits (`port_subs`), for the flags a
CPU caller of the port must pass.

Masked before the records are compared (the fields that must differ
between two live runs): `host:port` of 127.0.0.1, localhost and 0.0.0.0
(each package's servers bind their own ports); the run's directory;
the package name itself; memory addresses in reprs; floats between 1e9
and 1e11 and ints of 1e15 and more (wall-clock stamps in s, µs and ns);
the class of an object that is not a plain value, which is recorded
by its class name only; and a gRPC error's debug string (its status
code and details are kept).  Bytes and strings longer than 4 KiB are
recorded by length and sha256.  An assert a file's twin names in
`unrecorded` for a case records only its outcome (see `TwinFile`).
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import importlib
import inspect
import itertools
import operator
import os
import random
import re
import secrets
import sys
import textwrap
import threading
import types

import numpy as np
import pytest

from _torch_cluster import EPOCH_S, PACKAGES, PORT, Clock, \
    _reset_port_globals, seed_placement

TESTS = os.path.dirname(os.path.abspath(__file__))
_REF_NAME = re.compile(r"\bseaweedfs_tpu\b")
_PORT_NAME = re.compile(r"\bseaweedfs_tpu_torch\b")
_HOSTPORT = re.compile(r"(127\.0\.0\.1|localhost|0\.0\.0\.0):\d+")
_ADDR = re.compile(r"0x[0-9a-fA-F]{6,}")
_CMP = {"Eq": operator.eq, "NotEq": operator.ne, "Lt": operator.lt,
        "LtE": operator.le, "Gt": operator.gt, "GtE": operator.ge,
        "Is": operator.is_, "IsNot": operator.is_not,
        "In": lambda a, b: a in b, "NotIn": lambda a, b: a not in b}
BIG = 4096
HALF = {PACKAGES[0]: "the JAX package", PORT: "the port"}
# Process-wide counters whose absolute values reference cases assert
# on: a case that reads "no series yet" or "the count before" sees what
# every earlier test in the process left there (under xdist's
# --dist loadfile, the reference's own file may have run in the same
# worker).  Each package's half of a case starts them empty, as a fresh
# process has them, and gets the process's values back afterwards.
FRESH_COUNTERS = (("stats.metrics", "ec_stage_bytes"),
                  ("events.journal", "events_total"))
# The same for histograms (test_attribution.py counts the lock
# histograms' observations of its own locks), zeroed and given back in
# place: a lock's pre-resolved series handle holds its count list.
FRESH_HISTOGRAMS = (("stats.contention", "lock_wait_seconds"),
                    ("stats.contention", "lock_hold_seconds"))


def _zero_histogram(hist) -> dict:
    """Zero every series of `hist` in place; returns what they held."""
    with hist._lock:
        held = {k: (list(c), hist._sums[k], hist._totals[k])
                for k, c in hist._counts.items()}
        for k, c in hist._counts.items():
            c[:] = [0] * len(c)
            hist._sums[k], hist._totals[k] = 0.0, 0
    return held


def _restore_histogram(hist, held: dict) -> None:
    """Every series of `hist` back to what `held` says, in place; a
    series made since then to zero."""
    with hist._lock:
        for k, c in hist._counts.items():
            counts, total_s, n = held.get(k, ([0] * len(c), 0.0, 0))
            c[:] = counts
            hist._sums[k], hist._totals[k] = total_s, n


class Recorder:
    """The records of one run, and the masks of its directory; an
    assert on a thread other than the case's own goes into the set
    `thread_records`."""

    def __init__(self):
        self.records: list = []
        self.thread_records: set = set()
        self.owner = None
        self.roots: list[str] = []
        self.unrecorded: frozenset = frozenset()
        self.grpc_alike: frozenset = frozenset()
        self.subs: tuple = ()

    def text(self, s: str) -> str:
        for root in self.roots:
            s = s.replace(root, "<tmp>")
        for old, new in self.subs:
            s = s.replace(old, new)
        s = s.replace("seaweedfs_tpu_torch", "<pkg>").replace(
            "seaweedfs_tpu", "<pkg>")
        s = _HOSTPORT.sub("<host:port>", s)
        return _ADDR.sub("<addr>", s)

    def norm(self, v, depth: int = 0):
        if depth > 12:
            return "<deep>"
        if v is None or isinstance(v, bool):
            return v
        if isinstance(v, int):
            return "<stamp>" if abs(v) >= 10 ** 15 else v
        if isinstance(v, float):
            return "<stamp>" if 1e9 <= abs(v) <= 1e11 else v
        if isinstance(v, str):
            return self._big(self.text(v))
        if isinstance(v, (bytes, bytearray, memoryview)):
            b = bytes(v)
            if len(b) > BIG:
                return ("bytes", len(b), hashlib.sha256(b).hexdigest())
            return ("bytes", self.text(b.decode("latin-1")))
        if isinstance(v, dict):
            return {repr(self.norm(k, depth + 1)): self.norm(x, depth + 1)
                    for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [self.norm(x, depth + 1) for x in v]
        if isinstance(v, (set, frozenset)):
            return sorted((self.norm(x, depth + 1) for x in v), key=repr)
        if isinstance(v, np.ndarray):
            return ("ndarray", str(v.dtype), list(v.shape),
                    hashlib.sha256(np.ascontiguousarray(v).tobytes())
                    .hexdigest())
        if isinstance(v, np.generic):
            return self.norm(v.item(), depth)
        if isinstance(v, BaseException):
            if callable(getattr(v, "code", None)) \
                    and callable(getattr(v, "details", None)):
                # A grpc.RpcError: its status, not the debug string
                # (whose field order varies from call to call).
                code = str(v.code())
                if code in self.grpc_alike:
                    return ("raised", "grpc", sorted(self.grpc_alike))
                return ("raised", "grpc", code,
                        self.text(v.details() or ""))
            return ("raised", type(v).__name__, self.text(str(v)))
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {"__type__": type(v).__name__, **{
                f.name: self.norm(getattr(v, f.name), depth + 1)
                for f in dataclasses.fields(v)}}
        if isinstance(v, type):
            return ("class", v.__name__)
        return ("object", type(v).__name__)

    def _big(self, s: str):
        if len(s) > BIG:
            return ("str", len(s), hashlib.sha256(s.encode()).hexdigest())
        return s

    def _add(self, record) -> None:
        if self.owner is None or threading.get_ident() == self.owner:
            self.records.append(record)
        else:
            self.thread_records.add(repr(record))

    def compare(self, op: str, a, b, src: str = "") -> bool:
        ok = _CMP[op](a, b)
        if src in self.unrecorded:
            self._add(("unrecorded", src, bool(ok)))
        elif op in ("Eq", "NotEq"):
            self._add((op, self.norm(a), self.norm(b)))
        elif op in ("In", "NotIn"):
            self._add((op, self.norm(a), bool(ok)))
        else:
            self._add((op, bool(ok)))
        return ok

    def truth(self, v, src: str = "") -> bool:
        self._add(("unrecorded", src, bool(v)) if src in self.unrecorded
                  else ("truth", bool(v)))
        return v


class _Raises:
    """`with pytest.raises(...)` that records what was raised."""

    def __init__(self, rec: Recorder, cm):
        self.rec, self.cm = rec, cm

    def __enter__(self):
        self.info = self.cm.__enter__()
        return self.info

    def __exit__(self, *exc):
        out = self.cm.__exit__(*exc)
        if "raises" in self.rec.unrecorded:
            self.rec.records.append(("unrecorded", "raises",
                                     exc[1] is not None))
        else:
            self.rec.records.append(("raises", self.rec.norm(exc[1])))
        return out


class _Pytest:
    """The twin module's `pytest`: the real module, but `raises` as a
    context manager records the exception it caught."""

    def __init__(self, rec: Recorder):
        self._rec = rec

    def raises(self, *args, **kw):
        cm = pytest.raises(*args, **kw)
        return cm if len(args) > 1 else _Raises(self._rec, cm)

    def __getattr__(self, name):
        return getattr(pytest, name)


class _Os:
    """The twin module's `os`: the real module, but the bytes the test
    file draws from `urandom` (keys, payloads) come from the seeded
    `random`, alike in both packages.  The servers it starts draw
    from the real `os.urandom`."""

    @staticmethod
    def urandom(n: int) -> bytes:
        return random.getrandbits(8 * n).to_bytes(n, "big") if n else b""

    def __getattr__(self, name):
        return getattr(os, name)


def _fixture_marker(*args, **kw):
    """pytest.fixture's stand-in: marks the function with its
    arguments (params, autouse); scope is ignored (every case builds
    its fixtures anew)."""
    def mark(fn):
        fn._twin_fixture = {"params": kw.get("params"),
                            "ids": kw.get("ids"),
                            "autouse": kw.get("autouse", False)}
        return fn
    if args and callable(args[0]) and not kw:
        return mark(args[0])
    return mark


def _skipif_marker(condition, reason: str = "", **_kw):
    """pytest.mark.skipif's stand-in: a case whose condition holds is
    skipped in both packages, with the reference's reason."""
    def mark(fn):
        if condition:
            fn._twin_skip = reason or "skipped by the reference's skipif"
        return fn
    return mark


def _parametrize_marker(argnames, argvalues, ids=None, **_kw):
    def mark(fn):
        names = [n.strip() for n in argnames.split(",")] \
            if isinstance(argnames, str) else list(argnames)
        fn.__dict__.setdefault("_twin_parametrize", []).insert(
            0, (names, list(argvalues), ids))
        return fn
    return mark


class _Rewrite(ast.NodeTransformer):
    """asserts -> recorder calls; fixture/parametrize decorators ->
    markers; `from test_x import a` -> the twin copy of test_x."""

    def visit_Assert(self, node):
        self.generic_visit(node)
        t = node.test
        rec = ast.Name("__twin_rec__", ast.Load())
        # The assert's text, in the JAX package's names: what an
        # `unrecorded` entry names it by.
        src = ast.Constant(_PORT_NAME.sub("seaweedfs_tpu", ast.unparse(t)))
        if isinstance(t, ast.Compare) and len(t.ops) == 1:
            call = ast.Call(ast.Attribute(rec, "compare", ast.Load()),
                            [ast.Constant(type(t.ops[0]).__name__),
                             t.left, t.comparators[0], src], [])
        else:
            call = ast.Call(ast.Attribute(rec, "truth", ast.Load()),
                            [t, src], [])
        node.test = call
        return node

    def _decorators(self, node):
        out = []
        for d in node.decorator_list:
            src = ast.unparse(d)
            if src.startswith("pytest.fixture"):
                out.append(ast.Name("__twin_fixture__", ast.Load())
                           if not isinstance(d, ast.Call) else
                           ast.Call(ast.Name("__twin_fixture__", ast.Load()),
                                    d.args, d.keywords))
            elif src.startswith("pytest.mark.parametrize"):
                out.append(ast.Call(ast.Name("__twin_parametrize__",
                                             ast.Load()), d.args, d.keywords))
            elif src.startswith("pytest.mark.skipif") and \
                    isinstance(d, ast.Call):
                out.append(ast.Call(ast.Name("__twin_skipif__", ast.Load()),
                                    d.args, d.keywords))
            elif src.startswith("pytest.mark."):
                continue
            else:
                out.append(d)
        node.decorator_list = out

    def visit_FunctionDef(self, node):
        self._decorators(node)
        self.generic_visit(node)
        return node

    def visit_ClassDef(self, node):
        self._decorators(node)
        self.generic_visit(node)
        return node

    def visit_Import(self, node):
        # `import os`, at any depth: the twin's `os` (seeded urandom).
        rest = [a for a in node.names if (a.name, a.asname) != ("os", None)]
        if len(rest) == len(node.names):
            return node
        out = [ast.Assign([ast.Name("os", ast.Store())],
                          ast.Name("__twin_os__", ast.Load()))]
        return out + ([ast.Import(rest)] if rest else [])

    def visit_ImportFrom(self, node):
        if node.module and node.module.startswith("test_"):
            return [ast.Assign(
                [ast.Name(a.asname or a.name, ast.Store())],
                ast.Attribute(ast.Call(ast.Name("__twin_mod__", ast.Load()),
                                       [ast.Constant(node.module)], []),
                              a.name, ast.Load()))
                for a in node.names]
        return node


_MODULES: dict = {}


def load(name: str, pkg: str, port_subs: tuple = (),
         subs: tuple = ()) -> types.ModuleType:
    """The twin copy of tests/<name>.py for `pkg`, compiled once per
    process.  `subs` are (text, replacement) pairs applied to both
    packages' copies; `port_subs` to the port's copy after the package
    rename."""
    key = (name, pkg)
    if key in _MODULES:
        return _MODULES[key]
    with open(os.path.join(TESTS, name + ".py")) as f:
        src = f.read()
    for old, new in subs:
        assert old in src, f"{name}: {old!r} not in the source"
        src = src.replace(old, new)
    if pkg == PORT:
        src = _REF_NAME.sub(PORT, src)
        for old, new in port_subs:
            assert old in src, f"{name}: {old!r} not in the source"
            src = src.replace(old, new)
    tree = ast.fix_missing_locations(_Rewrite().visit(ast.parse(src)))
    mod = types.ModuleType(f"_twin_{pkg}_{name}")
    mod.__file__ = os.path.join(TESTS, name + ".py")
    mod.__dict__.update(__twin_rec__=Recorder(),
                        __twin_fixture__=_fixture_marker,
                        __twin_parametrize__=_parametrize_marker,
                        __twin_skipif__=_skipif_marker,
                        __twin_os__=_Os(),
                        __twin_mod__=lambda n: load(n, pkg))
    sys.modules[mod.__name__] = mod
    _MODULES[key] = mod
    exec(compile(tree, mod.__file__, "exec"), mod.__dict__)
    if "pytest" in mod.__dict__:
        mod.pytest = _Pytest(mod.__twin_rec__)
    return mod


@dataclasses.dataclass
class Case:
    id: str
    cls: str | None
    fn: str
    fixture_params: dict      # fixture name -> index into its params
    call_params: dict         # argument name -> index into its values


def _fixtures(mod, cls=None) -> dict:
    out = {n: f for n, f in vars(mod).items()
           if callable(f) and hasattr(f, "_twin_fixture")}
    if cls is not None:
        out.update({n: f for n, f in vars(cls).items()
                    if callable(f) and hasattr(f, "_twin_fixture")})
    return out


def _closure(fn, fixtures: dict, seen=None) -> list[str]:
    """Fixture names `fn` needs, transitively, autouse ones first."""
    seen = [] if seen is None else seen
    names = [n for n, f in fixtures.items() if f._twin_fixture["autouse"]]
    names += [p for p in inspect.signature(fn).parameters
              if p not in ("self", "request")]
    for n in names:
        if n in fixtures and n not in seen:
            seen.append(n)
            _closure(fixtures[n], fixtures, seen)
    return seen


def _id(value, i: int, ids) -> str:
    if ids is not None:
        return str(ids[i])
    if isinstance(value, (str, int, float, bool)) or value is None:
        return str(value)
    return f"{i}"


class TwinFile:
    """The cases of one JAX-package test file, runnable in both
    packages.  `clocked` names modules below the package whose `time`
    is pinned to one instant in each package's run (where the bytes an
    assert compares carry the wall clock, such as a needle's append
    stamp).  `prelude` maps a case to the cases that run before it on
    the same fixtures, where the file's module-scoped fixture carries
    state from one case to the next (a bucket an earlier case made).
    `port_subs` edit the port's copy of the source: (text, replacement)
    pairs, for the flags a CPU caller of the port must pass (a
    subprocess `server` takes `-device=cpu`).  `unrecorded` maps a
    case to the asserts (by their text as the reference writes it)
    whose operands depend on the run, not on the package: a process's
    random journal token, a count that depends on timing within one
    package.  Both packages must still pass such an assert; only its
    outcome is compared, not what it compared.  The entry "raises"
    does the same for the case's `pytest.raises` blocks: that each
    raised what it expects is compared, not what was raised.
    `record_subs` are (port's text, reference's text) pairs applied to
    the strings the port's run records, for the names `port_subs`
    mapped: the records then compare as if the names were the
    reference's.  `subs` edit both packages' copies alike, for what the
    file's fixtures set up (never an assert).  `grpc_alike` maps a case
    to gRPC status codes that its run's timing, not the package, picks
    between: a gRPC error with one of them records as the set, and any
    other error, gRPC or not, records as it is."""

    def __init__(self, name: str, clocked: tuple = (), prelude=None,
                 port_subs: tuple = (), unrecorded=None,
                 record_subs: tuple = (), subs: tuple = (),
                 grpc_alike=None):
        self.name = name.removesuffix(".py")
        self.clocked = clocked
        self.prelude = dict(prelude or {})
        self.unrecorded = {c: frozenset(a) for c, a in
                           (unrecorded or {}).items()}
        self.port_subs = tuple(port_subs)
        self.record_subs = tuple(record_subs)
        self.grpc_alike = {c: frozenset(f"StatusCode.{k}" for k in a)
                           for c, a in (grpc_alike or {}).items()}
        self.ref = load(self.name, PACKAGES[0], subs=subs)
        load(self.name, PORT, self.port_subs, subs)
        self.cases: dict[str, Case] = {}
        for attr, obj in vars(self.ref).items():
            if attr.startswith("test") and inspect.isfunction(obj) \
                    and obj.__module__ == self.ref.__name__:
                self._add(None, attr, obj)
            elif attr.startswith("Test") and inspect.isclass(obj) \
                    and obj.__module__ == self.ref.__name__:
                for m, fn in vars(obj).items():
                    if m.startswith("test") and inspect.isfunction(fn):
                        self._add(obj, m, fn)

    def _add(self, cls, name: str, fn) -> None:
        fixtures = _fixtures(self.ref, cls)
        axes = []  # (kind, name, values, ids)
        for f in _closure(fn, fixtures):
            p = fixtures[f]._twin_fixture
            if p["params"] is not None:
                axes.append(("fixture", f, p["params"], p["ids"]))
        for names, values, ids in getattr(fn, "_twin_parametrize", []):
            axes.append(("call", tuple(names), values, ids))
        prefix = f"{cls.__name__}::{name}" if cls else name
        for combo in itertools.product(*[range(len(a[2])) for a in axes]):
            parts = [_id(a[2][i], i, a[3]) for a, i in zip(axes, combo)]
            cid = prefix + (f"[{'-'.join(parts)}]" if parts else "")
            self.cases[cid] = Case(
                cid, cls.__name__ if cls else None, name,
                {a[1]: i for a, i in zip(axes, combo) if a[0] == "fixture"},
                {a[1]: i for a, i in zip(axes, combo) if a[0] == "call"})

    def ids(self, exclude=()) -> list[str]:
        return [c for c in self.cases if c not in exclude]

    def run(self, case_id: str, tmp_path, seed: int = 0) -> list:
        """The case in each package; both must pass and record alike.
        Returns the port's records."""
        case = self.cases[case_id]
        fn = getattr(getattr(self.ref, case.cls) if case.cls else self.ref,
                     case.fn)
        if getattr(fn, "_twin_skip", None):
            pytest.skip(fn._twin_skip)
        out = []
        for pkg in PACKAGES:
            root = tmp_path / ("port" if pkg == PORT else "ref")
            root.mkdir()
            if pkg == PORT:
                _reset_port_globals()
            random.seed(seed)
            np.random.seed(seed)
            before = [self.cases[c] for c in self.prelude.get(case_id, ())]
            try:
                out.append(_run_one(load(self.name, pkg), case, pkg, root,
                                    self.clocked, before,
                                    self.unrecorded.get(case_id,
                                                        frozenset()),
                                    seed, self.record_subs if pkg == PORT
                                    else (),
                                    self.grpc_alike.get(case_id,
                                                        frozenset())))
            except BaseException as e:
                e.add_note(f"{case_id}: failed in {HALF[pkg]}'s half")
                raise
        (ref, ref_threads), (port, port_threads) = out
        named = self.unrecorded.get(case_id, frozenset())
        hit = {r[1] for r in ref if r[0] == "unrecorded"}
        assert named <= hit, f"{case_id}: no assert reads {named - hit}"
        for i, (a, b) in enumerate(zip(ref, port)):
            assert a == b, (f"assert #{i} of {case_id} records differently:"
                            f"\nJAX package: {a!r}\nport:        {b!r}")
        assert len(ref) == len(port), (len(ref), len(port))
        assert ref_threads == port_threads, (
            f"{case_id}: the asserts of its threads record differently:"
            f"\nJAX package: {sorted(ref_threads)}"
            f"\nport:        {sorted(port_threads)}")
        assert ref or ref_threads or not _asserts(fn), \
            f"{case_id} recorded no assert"
        return port


class _Request:
    def __init__(self, param, finalizers: list):
        self.param = param
        self._finalizers = finalizers

    def addfinalizer(self, fn) -> None:
        self._finalizers.append(fn)


class _Factory:
    """tmp_path_factory's stand-in: directories below the run's root."""

    def __init__(self, root):
        self.root = root
        self.n = 0

    def mktemp(self, name: str, numbered: bool = True):
        self.n += 1
        d = self.root / (f"{name}{self.n}" if numbered else name)
        d.mkdir()
        return d

    def getbasetemp(self):
        return self.root


def _cpu_defaults(mp: pytest.MonkeyPatch, pkg: str) -> None:
    """The port's volume server and shell default to the card; the runs
    here have none, so their `device` default becomes "cpu"."""
    if pkg != PORT:
        return
    for modname, cls in (("cluster.volume_server", "VolumeServer"),
                         ("shell.env", "CommandEnv")):
        init = getattr(sys.modules.get(f"{PORT}.{modname}") or
                       __import__(f"{PORT}.{modname}", fromlist=[cls]),
                       cls).__init__
        sig = inspect.signature(init)
        names = [p.name for p in sig.parameters.values()
                 if p.default is not inspect.Parameter.empty
                 and p.kind != p.KEYWORD_ONLY]
        if "device" in names:
            d = list(init.__defaults__)
            d[names.index("device")] = "cpu"
            mp.setattr(init, "__defaults__", tuple(d))
        else:
            kw = dict(init.__kwdefaults__)
            kw["device"] = "cpu"
            mp.setattr(init, "__kwdefaults__", kw)


def _seeded_token_hex(nbytes: int = 32) -> str:
    return random.getrandbits(8 * nbytes).to_bytes(nbytes, "big").hex()


def _asserts(fn) -> bool:
    """Whether the test function holds an assert or a `raises` block
    (a case without one passes by not raising)."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(fn)))
    return any(isinstance(n, ast.Assert) or (
        isinstance(n, ast.Attribute) and n.attr == "raises")
        for n in ast.walk(tree))


class _SeededOs:
    """A module's `os` whose `urandom` draws from a seeded stream of its
    own (any thread)."""

    def __init__(self, seed: int):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()

    def urandom(self, n: int) -> bytes:
        with self._lock:
            return self._rng.getrandbits(8 * n).to_bytes(n, "big") \
                if n else b""

    def __getattr__(self, name):
        return getattr(os, name)


def _run_one(mod, case: Case, pkg: str, root, clocked=(),
             before=(), unrecorded=frozenset(), seed: int = 0,
             record_subs: tuple = (), grpc_alike=frozenset()) -> list:
    rec = mod.__twin_rec__
    rec.records = []
    rec.roots = [str(root)]
    rec.unrecorded = unrecorded
    rec.grpc_alike = grpc_alike
    rec.subs = record_subs
    rec.thread_records = set()
    rec.owner = threading.get_ident()
    # Twin modules imported by this one record into the same run.
    for (name, p), m in _MODULES.items():
        if p == pkg:
            m.__twin_rec__ = rec
            if isinstance(m.__dict__.get("pytest"), _Pytest):
                m.pytest._rec = rec
    cls = getattr(mod, case.cls) if case.cls else None
    fixtures = _fixtures(mod, cls)
    instance = cls() if cls else None
    mp = pytest.MonkeyPatch()
    finalizers: list = []
    values: dict = {}
    factory = _Factory(root)
    builtin = {"tmp_path": lambda: factory.mktemp("tmp", numbered=True),
               "tmp_path_factory": lambda: factory,
               "monkeypatch": lambda: mp}
    _cpu_defaults(mp, pkg)
    for name, attr in FRESH_COUNTERS:
        counter = getattr(importlib.import_module(f"{pkg}.{name}"), attr)
        mp.setattr(counter, "_values", {})
    held = [(hist, _zero_histogram(hist)) for hist in (
        getattr(importlib.import_module(f"{pkg}.{name}"), attr)
        for name, attr in FRESH_HISTOGRAMS)]
    # Ids drawn from `secrets` (hard-link ids) come from the seeded
    # `random` instead, alike in both packages.
    mp.setattr(secrets, "token_hex", _seeded_token_hex)
    seed_placement(mp, pkg, seed)
    # Trace and span ids come from a seeded stream of their own.
    tracer = __import__(f"{pkg}.trace.tracer", fromlist=["os"])
    mp.setattr(tracer, "os", _SeededOs(seed))
    clock = Clock(EPOCH_S)
    for name in clocked:
        mp.setattr(sys.modules.get(f"{pkg}.{name}")
                   or __import__(f"{pkg}.{name}", fromlist=["time"]),
                   "time", clock)

    def resolve(name: str, request_param=None):
        if name in values:
            return values[name]
        if name in builtin:
            values[name] = builtin[name]()
            return values[name]
        f = fixtures[name]
        if cls is not None and name in vars(cls):
            f = getattr(instance, name)
        spec = f._twin_fixture
        param = None
        if spec["params"] is not None:
            param = spec["params"][case.fixture_params[name]]
        kw = {}
        for p in inspect.signature(f).parameters:
            if p == "self":
                continue
            kw[p] = _Request(param, finalizers) if p == "request" \
                else resolve(p)
        v = f(**kw)
        if inspect.isgenerator(v):
            gen = v
            v = next(gen)
            finalizers.append(lambda g=gen: next(g, None))
        values[name] = v
        return v

    try:
        for n, f in fixtures.items():
            if f._twin_fixture["autouse"]:
                resolve(n)
        for c in (*before, case):
            fn = getattr(instance if cls else mod, c.fn)
            kw = {}
            for p in inspect.signature(fn).parameters:
                if p == "self":
                    continue
                hit = next((k for k in c.call_params if p in k), None)
                if hit is not None:
                    names, values_ = _param_axis(fn, hit)
                    v = values_[c.call_params[hit]]
                    kw[p] = v[names.index(p)] if len(names) > 1 else v
                else:
                    kw[p] = resolve(p)
            fn(**kw)
    finally:
        for fin in reversed(finalizers):
            fin()
        mp.undo()
        for hist, values in held:
            _restore_histogram(hist, values)
        rec.owner = None
    return rec.records, rec.thread_records


def _param_axis(fn, names: tuple):
    for n, values, _ids in getattr(fn, "_twin_parametrize", []):
        if tuple(n) == names:
            return list(n), values
    raise KeyError(names)
