"""The port's pilint (``repro_torch.analysis``) against the JAX package's.

PI001, PI004, PI005 and PI006 carry over: on the reference's fixture
corpus the two analyzers give the same findings, field for field, and
their CLIs and baselines interchange.  PI002 and PI003 are restated for
eager PyTorch and carry their own corpus, ``tests/fixtures/pilint_torch/``
(outside ``tests/fixtures/pilint/``, whose tests walk that tree), with
the same ``# expect: PI00X`` markers.  Then the tree itself is clean, the
device scopes cover the reference's jit scopes, and the launch guards
count what the one-launch-a-window contract says.  AST only, apart from
the last tests, which run a few windows on the CPU.
"""
import ast
import json
import os
import re
import tokenize

import numpy as np
import pytest
import torch

from repro.analysis import baseline as ref_baseline
from repro.analysis import walker as ref_walker
from repro.analysis.cli import main as ref_main
from repro.analysis.rules import iter_python_files
from repro.analysis.rules import lint_file as ref_lint_file
from repro_torch import data as tdata
from repro_torch import pipeline as tpipe
from repro_torch.analysis import LaunchGuard, launch_guard
from repro_torch.analysis import baseline as port_baseline
from repro_torch.analysis.cli import main as port_main
from repro_torch.analysis.rules import (DEVICE_SCOPES, ProjectConfig,
                                        all_rules, lint_file)
from repro_torch.core import distributed as tdist
from repro_torch.core import engine as tengine
from repro_torch.core import index as tpi
from repro_torch.core.batch import RANGE, SEARCH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_FIXDIR = os.path.join(ROOT, "tests", "fixtures", "pilint")
FIXDIR = os.path.join(ROOT, "tests", "fixtures", "pilint_torch")
CARRIED = ("PI001", "PI004", "PI005", "PI006")

_EXPECT_RE = re.compile(r"#\s*expect:\s*(PI\d{3})")
_DISABLE_RE = re.compile(r"#\s*pilint:\s*disable=([A-Za-z0-9_*,\s]+)(.*)$")

# the torch corpus's device scopes, by file
FIXTURE_SCOPES = (
    ("pilint_torch/pi002_bad.py", "hot", ("n",)),
    ("pilint_torch/pi002_bad.py", "step", ()),
    ("pilint_torch/pi002_good.py", "shaped", ("span",)),
    ("pipeline/pi003_bad.py", "execute_impl", ()),
    ("pipeline/pi003_good.py", "step_single", ("span",)),
    ("pilint_torch/pi003_outside_good.py", "decode_step", ()),
)
FIXTURE_CFG = ProjectConfig(device_scopes=FIXTURE_SCOPES)


def _files(top):
    out = []
    for dirpath, dirnames, filenames in os.walk(top):
        dirnames.sort()
        out.extend(os.path.join(dirpath, f) for f in sorted(filenames)
                   if f.endswith(".py"))
    return out


def _rel(path):
    return os.path.relpath(path, ROOT).replace(os.sep, "/")


def _expected_markers(path):
    marks = set()
    with open(path, encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            marks.update((m.group(1), lineno)
                         for m in _EXPECT_RE.finditer(line))
    return marks


def _carried_fixtures():
    """The reference's fixtures of the rules that carry over."""
    return [p for p in _files(REF_FIXDIR)
            if not re.search(r"pi00[23]", _rel(p))]


def _fields(findings):
    return [(f.path, f.line, f.col, f.rule, f.message, f.context)
            for f in findings if f.rule in CARRIED]


# ---------------------------------------------------------------------------
# parity with the reference's analyzer
# ---------------------------------------------------------------------------

def test_carried_fixtures_cover_the_carried_rules():
    marked = {rule for p in _carried_fixtures()
              for rule, _ in _expected_markers(p)}
    assert marked == set(CARRIED)


@pytest.mark.parametrize("path", _carried_fixtures(), ids=_rel)
def test_carried_rules_match_reference(path):
    want = _fields(ref_lint_file(path, _rel(path)))
    got = _fields(lint_file(path, _rel(path)))
    assert got == want
    assert {(f[3], f[1]) for f in got} == _expected_markers(path)


def test_cli_list_rules_match(capsys):
    ids = []
    for main in (ref_main, port_main):
        assert main(["--list-rules"]) == 0
        ids.append([line.split()[0] for line in
                    capsys.readouterr().out.splitlines()])
    assert ids[0] == ids[1] == [f"PI00{i}" for i in range(1, 7)]


@pytest.mark.parametrize("name,rc", [("pi005_bad.py", 1),
                                     ("pi005_good.py", 0)])
def test_cli_exit_codes_and_json_keys_match(tmp_path, capsys, name, rc):
    path = os.path.join(REF_FIXDIR, name)
    payloads = []
    for tag, main in (("ref", ref_main), ("port", port_main)):
        report = tmp_path / f"{tag}.json"
        assert main([path, "--no-baseline", "--json", str(report)]) == rc
        payloads.append(json.loads(report.read_text()))
    capsys.readouterr()
    ref, port = payloads
    assert sorted(ref) == sorted(port)
    assert sorted(ref["rules"]) == sorted(port["rules"])
    for key in ("findings", "new", "grandfathered",
                "stale_baseline_entries"):
        assert ref[key] == port[key], key


def test_cli_usage_error_exits_2(capsys):
    for main in (ref_main, port_main):
        with pytest.raises(SystemExit) as exc:
            main(["--no-such-flag"])
        assert exc.value.code == 2
    capsys.readouterr()


@pytest.mark.parametrize("writer,reader", [
    (port_baseline, ref_baseline), (ref_baseline, port_baseline)],
    ids=["port-to-ref", "ref-to-port"])
def test_baselines_interchange(tmp_path, writer, reader):
    """A baseline one package writes is read by the other, and both split
    the live findings into the same new, grandfathered and stale sets."""
    path = os.path.join(REF_FIXDIR, "pi005_bad.py")
    live = {port_baseline: lint_file(path, _rel(path)),
            ref_baseline: ref_lint_file(path, _rel(path))}
    assert len(live[port_baseline]) == 3
    bp = tmp_path / "baseline.json"
    writer.write(str(bp), live[writer])
    entries = reader.load(str(bp))
    # every finding grandfathered; then one fixed: one stale entry
    for cut in (0, 1):
        (new_p, grand_p, stale_p), (new_r, grand_r, stale_r) = (
            mod.diff(live[mod][cut:], entries)
            for mod in (port_baseline, ref_baseline))
        assert new_p == new_r == []
        assert _fields(grand_p) == _fields(grand_r)
        assert len(grand_p) == 3 - cut
        assert stale_p == stale_r and len(stale_p) == cut


def test_baseline_version_mismatch(tmp_path):
    bp = tmp_path / "baseline.json"
    bp.write_text(json.dumps({"version": 99, "findings": []}))
    with pytest.raises(ValueError, match="unsupported version"):
        port_baseline.load(str(bp))


def test_baseline_fingerprints_survive_line_shifts(tmp_path):
    path = os.path.join(FIXDIR, "pi005_bad.py")
    rel = _rel(path)
    bp = tmp_path / "baseline.json"
    port_baseline.write(str(bp), lint_file(path, rel))
    shifted = tmp_path / "shifted.py"
    with open(path, encoding="utf-8") as f:
        shifted.write_text("# a new comment shifts every line down\n"
                           + f.read())
    new, grandfathered, stale = port_baseline.diff(
        lint_file(str(shifted), rel), port_baseline.load(str(bp)))
    assert new == [] and stale == [] and len(grandfathered) == 2


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("comment,rules", [
    ("", ["PI005"]),
    ("  # pilint: disable=PI005 — named elsewhere", []),
    ("  # pilint: disable=PI004", ["PI005"]),
    ("  # pilint: disable=all", []),
    ("  # pilint: disable=*", []),
])
def test_inline_suppression(tmp_path, comment, rules):
    src = tmp_path / "x.py"
    src.write_text(f"EMPTY = torch.iinfo(torch.int32).max{comment}\n")
    assert [f.rule for f in lint_file(str(src), "x/x.py")] == rules


# ---------------------------------------------------------------------------
# the torch corpus: exact (rule, line) agreement with the inline markers
# ---------------------------------------------------------------------------

def test_torch_corpus_covers_every_rule():
    marked = {rule for p in _files(FIXDIR) for rule, _ in
              _expected_markers(p)}
    assert marked == {r.id for r in all_rules()}


@pytest.mark.parametrize("path", _files(FIXDIR), ids=_rel)
def test_torch_fixture_findings_exact(path):
    found = {(f.rule, f.line) for f in lint_file(path, _rel(path),
                                                 FIXTURE_CFG)}
    assert found == _expected_markers(path)


def test_device_scopes_cover_the_reference_jit_scopes():
    """Every function the reference's walker resolves as a jit scope, and
    whose mirrored file in the port defines it (up to a leading
    underscore), is a default device scope of the port; so are the train
    and decode steps."""
    scopes = {(s, n) for s, n, _ in DEVICE_SCOPES}
    statics = {(s, n): set(st) for s, n, st in DEVICE_SCOPES}
    covered = 0
    for path in iter_python_files([os.path.join(ROOT, "src", "repro")]):
        with open(path, encoding="utf-8") as f:
            ctx = ref_walker.FileContext(path, _rel(path), f.read())
        rel = _rel(path)[len("src/repro/"):]
        mirror = os.path.join(ROOT, "src", "repro_torch", rel)
        if not ctx.jit_functions or not os.path.exists(mirror):
            continue
        with open(mirror, encoding="utf-8") as f:
            defined = {n.name for n in ast.walk(ast.parse(f.read()))
                       if isinstance(n, ast.FunctionDef)}
        for fn, jit_statics in ctx.jit_functions.items():
            name = next((n for n in (fn.name, fn.name.lstrip("_"))
                         if n in defined), None)
            if name is None:
                continue
            assert (rel, name) in scopes, (rel, fn.name)
            # a static the port's function still takes stays static
            assert jit_statics - {"n_shards"} <= statics[(rel, name)], \
                (rel, name)
            covered += 1
    assert covered == 12
    assert {("models/steps.py", "train_step"),
            ("models/steps.py", "decode_step")} <= scopes


def test_default_scopes_resolve_in_the_port():
    """Each default device scope names a function its file defines."""
    for suffix, name, statics in DEVICE_SCOPES:
        path = os.path.join(ROOT, "src", "repro_torch", suffix)
        with open(path, encoding="utf-8") as f:
            fns = [n for n in ast.walk(ast.parse(f.read()))
                   if isinstance(n, ast.FunctionDef) and n.name == name]
        assert fns, (suffix, name)
        params = {a.arg for fn in fns
                  for a in fn.args.args + fn.args.kwonlyargs}
        assert set(statics) <= params, (suffix, name)


# ---------------------------------------------------------------------------
# acceptance: the tree is clean, every sanction carries its reason
# ---------------------------------------------------------------------------

def test_port_tree_is_clean(monkeypatch, capsys):
    monkeypatch.chdir(ROOT)
    rc = port_main(["src/repro_torch", "--baseline", "pilint-baseline.json"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "0 new" in out


def test_every_sanction_names_its_rule_and_reason():
    """A ``# pilint: disable=`` comment in the port names rules, never
    ``all``, and gives a reason after a dash."""
    n = 0
    for path in iter_python_files([os.path.join(ROOT, "src",
                                                "repro_torch")]):
        with open(path, encoding="utf-8") as f:
            comments = [(tok.start[0], tok.string) for tok in
                        tokenize.generate_tokens(f.readline)
                        if tok.type == tokenize.COMMENT]
        for lineno, text in comments:
            m = _DISABLE_RE.search(text)
            if not m:
                continue
            rules = [r.strip() for r in m.group(1).split(",") if r.strip()]
            assert rules and all(re.fullmatch(r"PI00\d", r)
                                 for r in rules), (path, lineno)
            assert re.match(r"\s*—\s*\S", m.group(2)), (path, lineno)
            n += 1
    assert n >= 4   # the sentinel registry's two, the two host reads


def test_port_imports_stdlib_only():
    """The analyzer imports the standard library and itself; only the
    default fault points come from ``repro_torch.faults``."""
    stdlib = {"ast", "argparse", "collections", "dataclasses", "json",
              "os", "posixpath", "re", "sys", "typing", "__future__"}
    pkg = os.path.join(ROOT, "src", "repro_torch", "analysis")
    assert len(_files(pkg)) == 12
    for path in _files(pkg):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top in stdlib or mod.startswith(
                    "repro_torch.analysis") or mod == "repro_torch.faults", \
                    (path, mod)


# ---------------------------------------------------------------------------
# launch guards (PI002's runtime half)
# ---------------------------------------------------------------------------

def test_launch_guard_expect_and_message():
    g = LaunchGuard("unit.test")
    base = g.count()
    g.bump()
    g.expect(base, 1, "one bump")
    with pytest.raises(AssertionError) as excinfo:
        g.expect(base, 2, "one bump")
    msg = str(excinfo.value)
    assert msg.startswith("launch_guard[unit.test]: 1 launch(es) during "
                          "one bump where 2 expected")
    assert msg.endswith("(PI002)")


def test_launch_guard_registry_is_shared():
    a = launch_guard("unit.shared")
    b = launch_guard("unit.shared")
    assert a is b
    base = a.count()
    b.bump()
    assert a.count() == base + 1


KERNEL_GUARDS = ("pi_search", "pi_probe", "pi_range", "bitonic_sort",
                 "flash_attention_fwd")


def test_cpu_calls_bump_no_kernel_guard():
    """A whole window, a range call, a lookup and an attention call on
    CPU tensors run the plain versions: no kernel guard moves."""
    from repro_torch.kernels import flash_attention as FA
    base = {n: launch_guard(n).count() for n in KERNEL_GUARDS}
    idx = tpi.build(tpi.PIConfig(capacity=256, pending_capacity=32,
                                 fanout=4), np.arange(0, 500, 5, np.int32),
                    np.arange(100, dtype=np.int32), device="cpu")
    q = torch.arange(0, 64, dtype=torch.int32)
    idx, _ = tpi.execute_impl(idx, torch.zeros(64, dtype=torch.int32), q, q)
    tpi.lookup(idx, q)
    tpi.traverse(idx, q)
    tpi.range_agg(idx, q, q + 10)
    x = torch.zeros(1, 16, 2, 16)
    FA.flash_attention_fwd(x, x, x)
    for name, b in base.items():
        launch_guard(name).expect(b, 0, "CPU calls")


ARRIVALS = dict(process="poisson", rate=1e5, n_arrivals=400, range_frac=0.3,
                span_min=1, span_max=2000, hot_keys=6, seed=3)
YCSB = dict(n_keys=300, key_space=1 << 16, write_ratio=0.5, theta=0.9,
            seed=4)


def _counting(monkeypatch, name):
    calls = []
    real = getattr(tengine, name)

    def counting(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(tengine, name, counting)
    return calls


@pytest.mark.parametrize("backend", ["cuda", "torch"])
def test_launch_counters_one_a_window(monkeypatch, backend):
    """``execute_launch_count()`` rises by one a window and
    ``range_launch_count()`` by one a range-bearing window on the ``cuda``
    backend (as many as its kernel calls, counted by monkeypatching the
    engine's launch functions); on the ``torch`` backend neither moves."""
    probes = _counting(monkeypatch, "pi_probe")
    ranges = _counting(monkeypatch, "pi_range")
    keys, vals = tdata.ycsb_dataset(tdata.YCSBConfig(**YCSB))
    stream = tpipe.make_arrivals(tpipe.ArrivalConfig(**ARRIVALS),
                                 tdata.YCSBConfig(**YCSB), keys)
    stream.ops[:64] = SEARCH     # the first two windows hold no RANGE
    cfg = tpi.PIConfig(capacity=1024, pending_capacity=64, fanout=4,
                       seg_width=16, tile_q=32, backend=backend)
    disp = tpipe.Dispatcher(tpi.build(cfg, keys, vals, device="cpu"),
                            depth=1, max_span=4096, clock=lambda: 0.0)
    e0, r0 = tpi.execute_launch_count(), tpipe.range_launch_count()
    retired = disp.run(stream, tpipe.WindowConfig(batch=32, coalesce=False))
    n_range = sum(r.rcnt is not None for r in retired)
    assert n_range == len(retired) - 2 > 0
    assert all((r.window.ops == RANGE).any() == (r.rcnt is not None)
               for r in retired)
    on = backend == "cuda"
    launch_guard("core.execute").expect(e0, len(retired) if on else 0,
                                        f"{backend} run")
    launch_guard("pipeline.ranges").expect(r0, n_range if on else 0,
                                           f"{backend} run")
    assert len(probes) == (len(retired) if on else 0)
    assert len(ranges) == (n_range if on else 0)


def test_range_counter_once_a_shard(monkeypatch):
    """On a sharded index ``range_launch_count()`` rises by S a window."""
    ranges = _counting(monkeypatch, "pi_range")
    keys, vals = tdata.ycsb_dataset(tdata.YCSBConfig(**YCSB))
    cfg = tpi.PIConfig(capacity=512, pending_capacity=32, fanout=4,
                       seg_width=16, tile_q=32)
    state = tdist.build_sharded(cfg, 4, keys, vals, device="cpu")
    lo = np.sort(keys)[:32]
    ops = np.full(32, RANGE, np.int32)
    base = tpipe.range_launch_count()
    for _ in range(2):
        tpipe.execute_ranges_sharded(state, ops, lo, lo + 5000, 64)
    launch_guard("pipeline.ranges").expect(base, 8, "two windows, S = 4")
    assert len(ranges) == 8
