"""The port's datlint rule engine, held to the JAX package's.

A port of ``test_datlint.py`` onto
``dat_replication_protocol_tpu_torch.analysis``: one known-bad and one
known-good fixture per rule, each distilled from the real incident that
motivated the rule (ANALYSIS.md maps rules to ADVICE.md findings), plus
the suppression syntax and the CLI contract the tier-1 gate relies on.
Every fixture goes through ``datlint_parity``, which runs the JAX
package's analyzer on the same files and requires the same findings.
The last section pins the port's five permitted differences, each on a
fixture where the two analyzers part.

The fixtures are deliberately minimal re-creations of the PRE-fix repo
patterns: if a rule stops firing on its bad fixture, the analyzer has
lost the ability to catch the bug class that motivated it.
"""

import json
import textwrap

import pytest

from datlint_parity import datlint_main, reference_findings, rows, run_paths
from dat_replication_protocol_tpu_torch.analysis import run_paths as port_paths


def _lint(tmp_path, *files, rules=None):
    """Write {name: source} pairs into tmp_path and lint the directory."""
    for name, source in files:
        (tmp_path / name).write_text(textwrap.dedent(source))
    return run_paths([tmp_path], rules=rules)


def _rules_fired(findings):
    return {f.rule for f in findings}


# -- cursor-coherence (ADVICE.md, high: bulk cursor desync) ---------

# the pre-fix shape of _dispatch_changes_fast: locals advance together,
# but the finally writes back only half the coupled cursor
CURSOR_BAD = '''
# datlint: coupled-state st["f"], st["row"]

def dispatch(st, frames, rows, deliver):
    f = st["f"]
    row = st["row"]
    try:
        while f < len(frames):
            payload = frames[f]
            row += 1
            f += 1
            deliver(payload, rows[row - 1])
    finally:
        st["row"] = row
'''

CURSOR_GOOD = '''
# datlint: coupled-state st["f"], st["row"]

def dispatch(st, frames, rows, deliver):
    f = st["f"]
    row = st["row"]
    try:
        while f < len(frames):
            payload = frames[f]
            row += 1
            f += 1
            deliver(payload, rows[row - 1])
    finally:
        st["f"] = f
        st["row"] = row
'''


def test_cursor_coherence_fires_on_half_writeback(tmp_path):
    findings = _lint(tmp_path, ("desync.py", CURSOR_BAD))
    assert "cursor-coherence" in _rules_fired(findings)
    # both shapes are reported: the subset finally AND the absence of
    # any finally covering the full set
    msgs = [f.message for f in findings if f.rule == "cursor-coherence"]
    # canonical form uses single quotes (ast.unparse)
    assert any("st['f']" in m and "not" in m for m in msgs)


def test_cursor_coherence_fires_on_no_finally_at_all(tmp_path):
    findings = _lint(tmp_path, ("bare.py", '''
        # datlint: coupled-state st["f"], st["row"]

        def advance(st):
            st["row"] += 1
            st["f"] += 1
    '''))
    assert "cursor-coherence" in _rules_fired(findings)


def test_cursor_coherence_clean_on_atomic_writeback(tmp_path):
    assert _lint(tmp_path, ("atomic.py", CURSOR_GOOD)) == []


def test_cursor_coherence_ignores_undeclared_modules(tmp_path):
    # no coupled-state declaration: the rule constrains nothing
    source = CURSOR_BAD.replace("# datlint: coupled-state", "# not-a-decl")
    assert _lint(tmp_path, ("free.py", source)) == []


def test_cursor_coherence_malformed_declaration_is_a_finding(tmp_path):
    """A declaration the rule cannot honor must FAIL datlint, not turn
    the rule off while the run still reports clean (dropping the comma
    would otherwise ship the exact half-write-back regression green)."""
    source = CURSOR_BAD.replace('st["f"], st["row"]', 'st["f"] st["row"]')
    findings = _lint(tmp_path, ("desync.py", source))
    msgs = [f.message for f in findings if f.rule == "cursor-coherence"]
    assert any("unparsable member" in m for m in msgs), findings


def test_cursor_coherence_single_member_declaration_is_a_finding(tmp_path):
    # one member is not a coupling; silently ignoring it disables the rule
    source = CURSOR_BAD.replace('st["f"], st["row"]', 'st["row"]')
    findings = _lint(tmp_path, ("desync.py", source))
    msgs = [f.message for f in findings if f.rule == "cursor-coherence"]
    assert any("at least two" in m for m in msgs), findings


# -- env-cache-policy (ADVICE.md, low: DISABLE split-brain) ---------

# the pre-fix change_codec._fastpath_mod: the env decision is frozen
# into the module cache on first call
ENV_BAD_FN = '''
import os

_cache = None
_tried = False


def get():
    global _cache, _tried
    if not _tried:
        _tried = True
        if os.environ.get("DAT_FASTPATH_DISABLE"):
            _cache = None
        else:
            _cache = object()
    return _cache
'''

ENV_GOOD = '''
import os

_cache = None
_tried = False


def get():
    if os.environ.get("DAT_FASTPATH_DISABLE"):
        return None
    return _load_once()


def _load_once():
    global _cache, _tried
    if not _tried:
        _tried = True
        _cache = object()
    return _cache
'''


def test_env_cache_fires_on_frozen_function_cache(tmp_path):
    findings = _lint(tmp_path, ("frozen.py", ENV_BAD_FN))
    assert _rules_fired(findings) == {"env-cache-policy"}


def test_env_cache_fires_on_module_level_env_read(tmp_path):
    findings = _lint(tmp_path, ("modlevel.py", '''
        import os

        FASTPATH_OFF = os.environ.get("DAT_FASTPATH_DISABLE")
    '''))
    assert _rules_fired(findings) == {"env-cache-policy"}


def test_env_cache_clean_on_per_call_read(tmp_path):
    assert _lint(tmp_path, ("shared.py", ENV_GOOD)) == []


# -- unbounded-join (ADVICE.md, low: sidecar drain hang) ------------

JOIN_BAD = '''
def run_session(sender, sock):
    sock.settimeout(None)
    sender.join()
'''

JOIN_GOOD = '''
def run_session(sender, sock, parts):
    sock.settimeout(30.0)
    while sender.is_alive():
        sender.join(timeout=0.25)
    return ", ".join(parts)
'''


def test_unbounded_join_fires_on_bare_join_and_settimeout_none(tmp_path):
    findings = _lint(tmp_path, ("hang.py", JOIN_BAD))
    assert [f.rule for f in findings] == ["unbounded-join"] * 2


def test_unbounded_join_clean_on_bounded_waits(tmp_path):
    # str.join with an argument must NOT be confused with Thread.join
    assert _lint(tmp_path, ("bounded.py", JOIN_GOOD)) == []


# -- bounded-wait (lost-wakeup hangs; aio's bare awaits) -----------

# the pre-fix shape of aio.send_over_async: an idle encoder whose
# producer dies parks the pump task forever in wait(); a peer that
# stops reading parks it forever in drain()
WAIT_BAD = '''
async def pump(encoder, readable, writer):
    while True:
        data = encoder.read(65536)
        if not data:
            await readable.wait()
            continue
        writer.write(data)
        await writer.drain()
'''

WAIT_GOOD = '''
import asyncio


async def pump(encoder, readable, writer):
    while True:
        data = encoder.read(65536)
        if not data:
            await asyncio.wait_for(readable.wait(), 0.5)
            continue
        writer.write(data)
        await asyncio.wait_for(writer.drain(), 30.0)


def threaded_pump(event):
    while not event.wait(0.5):
        pass
'''


def test_bounded_wait_fires_on_bare_wait_and_drain(tmp_path):
    findings = _lint(tmp_path, ("hangs.py", WAIT_BAD))
    waits = [f for f in findings if f.rule == "bounded-wait"]
    assert len(waits) == 2
    joined = " ".join(f.message for f in waits)
    assert ".wait()" in joined and ".drain()" in joined


def test_bounded_wait_clean_on_wait_for_and_timeouts(tmp_path):
    assert _lint(tmp_path, ("bounded.py", WAIT_GOOD)) == []


def test_bounded_wait_allow_marker_is_the_escape_hatch(tmp_path):
    findings = _lint(tmp_path, ("justified.py", '''
        async def pump(writer, event):
            # datlint: allow-unbounded-wait -- peer trusted, see docstring
            await writer.drain()
            await event.wait()  # datlint: allow-unbounded-wait -- same
    '''))
    assert findings == []


def test_bounded_wait_does_not_double_report_join(tmp_path):
    # .join() belongs to unbounded-join; one finding, not two
    findings = _lint(tmp_path, ("joins.py", JOIN_BAD))
    assert "bounded-wait" not in _rules_fired(findings)


# -- jit-purity (PERF.md: host effects inside traced bodies) ----------------

JIT_BAD = '''
import os

import jax
import numpy as np


@jax.jit
def step(x):
    if os.environ.get("DAT_DEBUG"):
        x = x + 1
    return x


def kernel(x, out):
    host = np.asarray(x)
    out.block_until_ready()
    return host


traced = jax.jit(kernel)
'''

JIT_GOOD = '''
import os

import jax
import jax.numpy as jnp

DEBUG = bool(os.environ.get("DAT_DEBUG"))  # datlint: disable=env-cache-policy -- fixture: frozen on purpose


@jax.jit
def step(x):
    return jnp.sum(x * 2)


def host_helper(x):
    # not traced: environment reads and host syncs are fine here
    if os.environ.get("DAT_DEBUG"):
        x.block_until_ready()
    return x
'''


def test_jit_purity_fires_on_env_read_sync_and_materialize(tmp_path):
    findings = _lint(tmp_path, ("impure.py", JIT_BAD))
    impure = [f for f in findings if f.rule == "jit-purity"]
    joined = " ".join(f.message for f in impure)
    assert "os.environ" in joined          # frozen trace-time env read
    assert "block_until_ready" in joined   # host sync point
    assert "np.asarray" in joined          # device->host transfer
    assert len(impure) == 3


def test_jit_purity_clean_on_pure_traced_body(tmp_path):
    assert _lint(tmp_path, ("pure.py", JIT_GOOD)) == []


# -- wire-constant-parity (cross-implementation constant drift) -------------

WIRE_PY = '''
MAX_VARINT_LEN = 10
MAX_HEADER_LEN = MAX_VARINT_LEN + 1

TYPE_HEADER = 0
TYPE_CHANGE = 1
TYPE_BLOB = 2
'''

WIRE_C_GOOD = '''
enum FrameType {
  TYPE_HEADER = 0,
  TYPE_CHANGE = 1,
  TYPE_BLOB = 2,
};
// wire: MAX_VARINT_LEN = 10
#define MAX_HEADER_LEN 11
'''

# a drifted C copy: TYPE_BLOB renumbered, the varint cap widened
WIRE_C_BAD = WIRE_C_GOOD.replace("TYPE_BLOB = 2", "TYPE_BLOB = 3").replace(
    "MAX_VARINT_LEN = 10", "MAX_VARINT_LEN = 12")


def test_wire_parity_fires_on_cross_language_drift(tmp_path):
    findings = _lint(tmp_path, ("consts.py", WIRE_PY),
                     ("native.cpp", WIRE_C_BAD))
    drift = [f for f in findings if f.rule == "wire-constant-parity"]
    assert {m.split("wire constant ")[1].split(" ")[0] for m in
            (f.message for f in drift)} == {"TYPE_BLOB", "MAX_VARINT_LEN"}


def test_wire_parity_clean_when_constants_agree(tmp_path):
    # includes the folded MAX_HEADER_LEN = MAX_VARINT_LEN + 1 == 11
    assert _lint(tmp_path, ("consts.py", WIRE_PY),
                 ("native.cpp", WIRE_C_GOOD)) == []


def test_wire_parity_fires_on_python_python_drift(tmp_path):
    findings = _lint(tmp_path, ("a.py", "TYPE_CHANGE = 1\n"),
                     ("b.py", "_TYPE_CHANGE = 7\n"))  # underscore-stripped
    assert _rules_fired(findings) == {"wire-constant-parity"}


def test_wire_parity_single_site_constrains_nothing(tmp_path):
    assert _lint(tmp_path, ("only.py", "TYPE_CHANGE = 99\n")) == []


# ChangeBatch extension constants: the frame id, the payload version
# byte, and the capability-negotiation bit are all watched — a fork in
# any of them ships a peer that silently stops understanding itself
BATCH_PY = '''
TYPE_CHANGE_BATCH = 3
CAP_CHANGE_BATCH = 1
BATCH_VERSION = 1
'''

BATCH_C_GOOD = '''
// wire: TYPE_CHANGE_BATCH = 3
constexpr int BATCH_VERSION = 1;
'''


def test_wire_parity_covers_change_batch_constants(tmp_path):
    bad = BATCH_C_GOOD.replace("TYPE_CHANGE_BATCH = 3",
                               "TYPE_CHANGE_BATCH = 4").replace(
        "BATCH_VERSION = 1;", "BATCH_VERSION = 2;")
    findings = _lint(tmp_path, ("consts.py", BATCH_PY),
                     ("native.cpp", bad))
    drift = [f for f in findings if f.rule == "wire-constant-parity"]
    assert {m.split("wire constant ")[1].split(" ")[0] for m in
            (f.message for f in drift)} == {"TYPE_CHANGE_BATCH",
                                            "BATCH_VERSION"}


def test_wire_parity_change_batch_clean_when_agreeing(tmp_path):
    assert _lint(tmp_path, ("consts.py", BATCH_PY),
                 ("native.cpp", BATCH_C_GOOD)) == []


def test_wire_parity_cap_constant_python_python_drift(tmp_path):
    findings = _lint(tmp_path, ("a.py", "CAP_CHANGE_BATCH = 1\n"),
                     ("b.py", "CAP_CHANGE_BATCH = 2\n"))
    assert _rules_fired(findings) == {"wire-constant-parity"}


# Gear CDC scramble constants: ops/rabin.py and BOTH native
# scan loops (dat_gear_candidates + the fused dat_cdc_hash) write them
# down independently — a fork is a route fork: two "equivalent" engines
# silently cutting different chunks.
GEAR_PY = '''
_GEAR_C1 = 0x9E3779B1
_GEAR_C2 = 0x85EBCA77
'''

GEAR_C_GOOD = '''
// wire: GEAR_C1 = 0x9E3779B1
// wire: GEAR_C2 = 0x85EBCA77
const uint32_t c1 = 0x9E3779B1u, c2 = 0x85EBCA77u;
'''


def test_wire_parity_covers_gear_constants(tmp_path):
    bad = GEAR_C_GOOD.replace("GEAR_C1 = 0x9E3779B1",
                              "GEAR_C1 = 0x9E3779B9")
    findings = _lint(tmp_path, ("rabin.py", GEAR_PY), ("native.cpp", bad))
    drift = [f for f in findings if f.rule == "wire-constant-parity"]
    assert {m.split("wire constant ")[1].split(" ")[0] for m in
            (f.message for f in drift)} == {"GEAR_C1"}


def test_wire_parity_gear_constants_clean_when_agreeing(tmp_path):
    assert _lint(tmp_path, ("rabin.py", GEAR_PY),
                 ("native.cpp", GEAR_C_GOOD)) == []


# Rateless reconciliation constants: the negotiation trio
# (frame type / capability bit / payload version) plus the splitmix64
# mapping constants written down independently in ops/rateless.py and
# the native dat_rateless_build engine — a mapping fork is a route fork
# (two engines assigning elements to different coded symbols, a symbol
# stream that silently never decodes).
RECONCILE_PY = '''
TYPE_RECONCILE = 4
CAP_RECONCILE = 2
RECONCILE_VERSION = 1
RATELESS_GAMMA = 0x9E3779B97F4A7C15
RATELESS_MIX1 = 0xBF58476D1CE4E5B9
RATELESS_MIX2 = 0x94D049BB133111EB
'''

RECONCILE_C_GOOD = '''
// wire: TYPE_RECONCILE = 4
// wire: RECONCILE_VERSION = 1
// wire: RATELESS_GAMMA = 0x9E3779B97F4A7C15
// wire: RATELESS_MIX1 = 0xBF58476D1CE4E5B9
// wire: RATELESS_MIX2 = 0x94D049BB133111EB
'''


def test_wire_parity_covers_reconcile_constants(tmp_path):
    bad = RECONCILE_C_GOOD.replace(
        "TYPE_RECONCILE = 4", "TYPE_RECONCILE = 5").replace(
        "RATELESS_GAMMA = 0x9E3779B97F4A7C15",
        "RATELESS_GAMMA = 0x9E3779B97F4A7C16")
    findings = _lint(tmp_path, ("rateless.py", RECONCILE_PY),
                     ("native.cpp", bad))
    drift = [f for f in findings if f.rule == "wire-constant-parity"]
    assert {m.split("wire constant ")[1].split(" ")[0] for m in
            (f.message for f in drift)} == {"TYPE_RECONCILE",
                                            "RATELESS_GAMMA"}


def test_wire_parity_reconcile_constants_clean_when_agreeing(tmp_path):
    assert _lint(tmp_path, ("rateless.py", RECONCILE_PY),
                 ("native.cpp", RECONCILE_C_GOOD)) == []


def test_wire_parity_cap_reconcile_python_python_drift(tmp_path):
    findings = _lint(tmp_path, ("a.py", "CAP_RECONCILE = 2\n"),
                     ("b.py", "CAP_RECONCILE = 4\n"))
    assert _rules_fired(findings) == {"wire-constant-parity"}


def test_obs_discipline_covers_fused_route_telemetry(tmp_path):
    # the single-pass module's counters/engine notes carry the same
    # literal-name contract as every other telemetry site
    findings = _lint(tmp_path, ("fused.py", '''
        def f(_counter, _note_engine, which):
            _counter("cdc.fused." + which).inc()
            _note_engine("cdc.hash", "fused1p-native", bytes=1)
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 1


# -- suppressions -----------------------------------------------------------

def test_line_suppression_silences_one_finding(tmp_path):
    findings = _lint(tmp_path, ("sup.py", '''
        def wait(sender, other):
            sender.join()  # datlint: disable=unbounded-join -- test only
            other.join()
    '''))
    assert len(findings) == 1 and findings[0].rule == "unbounded-join"
    assert findings[0].line == 4  # only the unsuppressed join


def test_comment_line_above_suppresses_the_next_line(tmp_path):
    findings = _lint(tmp_path, ("above.py", '''
        def wait(sender):
            # datlint: disable=unbounded-join -- drained by caller
            sender.join()
    '''))
    assert findings == []


def test_file_suppression_silences_whole_file(tmp_path):
    findings = _lint(tmp_path, ("filewide.py", '''
        # datlint: disable-file=unbounded-join -- fixture: joins audited
        def wait(a, b):
            a.join()
            b.join()
    '''))
    assert findings == []


def test_suppression_in_string_literal_is_inert(tmp_path):
    findings = _lint(tmp_path, ("strlit.py", '''
        DOC = "datlint: disable-file=unbounded-join"

        def wait(sender):
            sender.join()
    '''))
    assert len(findings) == 1


def test_stale_suppression_flags_a_marker_suppressing_nothing(tmp_path):
    findings = _lint(tmp_path, ("stale.py", '''
        def quiet():
            return 1  # datlint: disable=unbounded-join -- long gone
    '''))
    assert [f.rule for f in findings] == ["stale-suppression"]
    assert "zero findings" in findings[0].message
    assert findings[0].line == 3


def test_suppression_without_a_reason_is_a_finding(tmp_path):
    # the suppression WORKS (no unbounded-join finding) but the missing
    # justification is itself reported: audited exceptions carry their
    # why in the same comment
    findings = _lint(tmp_path, ("noreason.py", '''
        def wait(sender):
            sender.join()  # datlint: disable=unbounded-join
    '''))
    assert [f.rule for f in findings] == ["stale-suppression"]
    assert "reason" in findings[0].message


def test_used_and_reasoned_suppression_is_silent(tmp_path):
    findings = _lint(tmp_path, ("used.py", '''
        def wait(sender):
            sender.join()  # datlint: disable=unbounded-join -- drained
    '''))
    assert findings == []


def test_wildcard_suppression_is_not_judged_for_staleness(tmp_path):
    # disable-file=all suppresses ANY rule, so "suppressed zero
    # findings" is not decidable per-rule — never guess; the reason
    # requirement still applies (and is satisfied here)
    findings = _lint(tmp_path, ("wild.py", '''
        # datlint: disable-file=all -- fixture: blanket escape hatch
        def quiet():
            return 1
    '''))
    assert findings == []


def test_stale_audit_skips_rules_that_did_not_run(tmp_path):
    from dat_replication_protocol_tpu_torch.analysis.engine import \
        StaleSuppression

    # unbounded-join is not in this run, so its marker's staleness is
    # unknowable — only the reason requirement is checkable (and met)
    findings = _lint(tmp_path, ("subset.py", '''
        def quiet():
            return 1  # datlint: disable=unbounded-join -- other run
    '''), rules=[StaleSuppression()])
    assert findings == []


def test_c_comment_suppression(tmp_path):
    # two C twins disagreeing on an explicit `// wire:` marker: the
    # finding lands on the FIRST site (a.cpp), where the C-comment
    # suppression must both silence it AND be credited as used (no
    # stale-suppression echo)
    findings = _lint(
        tmp_path,
        ("a.cpp",
         "// wire: TYPE_CHANGE = 1"
         "  // datlint: disable=wire-constant-parity -- fixture drift\n"),
        ("b.cpp", "// wire: TYPE_CHANGE = 2\n"))
    assert findings == []


# -- engine edges -----------------------------------------------------------

def test_unparsable_python_is_a_finding_not_a_skip(tmp_path):
    findings = _lint(tmp_path, ("broken.py", "def f(:\n"))
    assert [f.rule for f in findings] == ["parse-error"]


def test_rule_filter_runs_only_selected_rules(tmp_path):
    findings = _lint(tmp_path, ("both.py", JOIN_BAD + ENV_BAD_FN),
                     rules=None)
    assert _rules_fired(findings) >= {"unbounded-join", "env-cache-policy"}
    from dat_replication_protocol_tpu_torch.analysis import rule_by_name
    only = run_paths([tmp_path], rules=[rule_by_name("unbounded-join")])
    assert _rules_fired(only) == {"unbounded-join"}


# -- CLI contract (what the tier-1 gate and pre-merge hooks rely on) --------

def test_cli_exit_codes(tmp_path, capsys):
    clean = tmp_path / "clean"
    clean.mkdir()
    (clean / "ok.py").write_text("X = 1\n")
    assert datlint_main([str(clean)]) == 0
    assert "clean" in capsys.readouterr().out

    dirty = tmp_path / "dirty"
    dirty.mkdir()
    (dirty / "bad.py").write_text("def f(t):\n    t.join()\n")
    assert datlint_main([str(dirty)]) == 1
    out = capsys.readouterr().out
    assert "unbounded-join" in out and "finding" in out

    assert datlint_main(["--rule", "no-such-rule", str(clean)]) == 2
    assert datlint_main([str(tmp_path / "missing")]) == 2


def test_cli_list_rules_names_all_five(capsys):
    assert datlint_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for name in ("cursor-coherence", "env-cache-policy", "unbounded-join",
                 "jit-purity", "wire-constant-parity"):
        assert name in out


def test_findings_are_sorted_and_rendered_with_location(tmp_path):
    findings = _lint(tmp_path, ("zz.py", JOIN_BAD), ("aa.py", JOIN_BAD))
    assert findings == sorted(findings)
    rendered = findings[0].render()
    assert "aa.py" in rendered and "unbounded-join:" in rendered


# -- obs-discipline (greppable telemetry names; stdout is wire) ----

OBS_BAD = '''
def instrument(kind, registry, emit):
    c = registry.counter(f"decoder.{kind}")
    c.inc()
    emit("decoder." + kind, offset=0)
    print("decoded a frame")
'''

OBS_GOOD = '''
import sys

def instrument(registry, emit):
    c = registry.counter("decoder.changes")
    c.inc()
    emit("protocol.error", offset=0)
    print("diagnostics", file=sys.stderr)
'''


def test_obs_discipline_fires_on_dynamic_names_and_bare_print(tmp_path):
    findings = _lint(tmp_path, ("dyn.py", OBS_BAD))
    obs = [f for f in findings if f.rule == "obs-discipline"]
    assert len(obs) == 3  # f-string counter, concatenated emit, bare print
    msgs = " ".join(f.message for f in obs)
    assert "non-literal" in msgs and "print" in msgs


def test_obs_discipline_clean_on_literals_and_stderr(tmp_path):
    assert _lint(tmp_path, ("lit.py", OBS_GOOD)) == []


def test_obs_discipline_matches_hoisted_underscore_aliases(tmp_path):
    # the package idiom: `from ..obs.metrics import counter as _counter`
    findings = _lint(tmp_path, ("alias.py", '''
        def instrument(_counter, _emit, name):
            _counter(name).inc()
            _emit(name, x=1)
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 2


def test_obs_discipline_exempts_cli_main_prints(tmp_path):
    # a __main__.py CLI's stdout IS its interface
    main_dir = tmp_path / "somepkg"
    main_dir.mkdir()
    (main_dir / "__main__.py").write_text('print("findings: 0")\n')
    findings = run_paths([tmp_path])
    assert "obs-discipline" not in _rules_fired(findings)


def test_obs_discipline_exempts_the_obs_plumbing_itself(tmp_path):
    # obs/metrics.py forwards `name` params by design — not a site
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    (obs_dir / "metrics.py").write_text(textwrap.dedent('''
        def counter(name):
            return REGISTRY.counter(name)
    '''))
    findings = run_paths([tmp_path])
    assert "obs-discipline" not in _rules_fired(findings)


def test_obs_discipline_suppression(tmp_path):
    findings = _lint(tmp_path, ("sup.py", '''
        def instrument(emit, name):
            emit(name, x=1)  # datlint: disable=obs-discipline
    '''))
    assert "obs-discipline" not in _rules_fired(findings)


# -- obs-discipline: fleet-plane extensions ----------------------

def test_obs_discipline_watermark_role_must_be_literal(tmp_path):
    # the watermark ROLE keys the fleet lag join — same greppability
    # contract as metric names; the LINK argument is runtime by design
    findings = _lint(tmp_path, ("wm.py", '''
        def register(WATERMARKS, role, link, j):
            WATERMARKS.track(role, link, lambda: j.end)
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 1
    findings = _lint(tmp_path, ("wm_ok.py", '''
        def register(WATERMARKS, link, j):
            WATERMARKS.track("append", link, lambda: j.end)
    '''))
    # tmp_path still holds wm.py from above — scope to the literal case
    assert not [f for f in findings if f.path.endswith("wm_ok.py")]


def test_obs_discipline_exempts_fleet_plane_plumbing(tmp_path):
    # obs/watermarks.py renders labeled names from tracked state,
    # obs/fleet.py ships whole snapshots — plumbing, not sites
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    (obs_dir / "watermarks.py").write_text(textwrap.dedent('''
        def _collect(links):
            return {f"session.wire.offset{{link={k}}}": v
                    for k, v in links.items()}

        def track(role, link, fn, registry):
            registry.gauge(role + link)
    '''))
    (obs_dir / "fleet.py").write_text(textwrap.dedent('''
        def join(name, registry):
            return registry.counter(name)
    '''))
    findings = run_paths([tmp_path])
    assert "obs-discipline" not in _rules_fired(findings)


HEALTHZ_LOCK_BAD = '''
def serve_healthz(self):
    with self._lock:
        return {"ok": True, "sessions": len(self._sessions)}
'''

HEALTHZ_DISPATCH_BAD = '''
def default_healthz(pipeline):
    pipeline.flush()
    return {"ok": True}
'''

HEALTHZ_OK = '''
def default_healthz(self, admission_fn):
    adm = admission_fn()
    return {"ok": bool(adm.get("open"))}

def other_route(self):
    with self._lock:  # non-healthz handlers may lock (snapshots do)
        return dict(self._state)
'''


def _lint_obs_http(tmp_path, source):
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir(exist_ok=True)
    (obs_dir / "http.py").write_text(textwrap.dedent(source))
    return run_paths([tmp_path])


def test_healthz_handler_must_not_take_a_lock(tmp_path):
    findings = _lint_obs_http(tmp_path, HEALTHZ_LOCK_BAD)
    obs = [f for f in findings if f.rule == "obs-discipline"]
    assert len(obs) == 1 and "lock-free" in obs[0].message


def test_healthz_handler_must_not_dispatch(tmp_path):
    findings = _lint_obs_http(tmp_path, HEALTHZ_DISPATCH_BAD)
    obs = [f for f in findings if f.rule == "obs-discipline"]
    assert len(obs) == 1 and "device" in obs[0].message


def test_healthz_check_scoped_to_healthz_functions_in_obs_http(tmp_path):
    # locks in NON-healthz functions of obs/http.py are fine, and the
    # same healthz-named code outside obs/http.py is out of scope
    assert "obs-discipline" not in _rules_fired(
        _lint_obs_http(tmp_path, HEALTHZ_OK))
    findings = _lint(tmp_path, ("elsewhere.py", HEALTHZ_LOCK_BAD))
    assert "obs-discipline" not in _rules_fired(findings)


def test_obs_discipline_covers_trace_span_sites(tmp_path):
    # span names carry the same literal-name contract
    # as event names — the timeline CLI and trace viewers key on them
    findings = _lint(tmp_path, ("sp.py", '''
        def f(trace_span, trace_instant, phase):
            with trace_span(phase):
                trace_instant("decoder." + phase, offset=0)
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 2


def test_obs_discipline_clean_on_literal_span_names(tmp_path):
    assert _lint(tmp_path, ("spok.py", '''
        def f(trace_span, trace_instant):
            with trace_span("reconnect.attempt", attempt=1):
                trace_instant("decoder.frame", offset=0)
    ''')) == []


def test_obs_discipline_matches_tracing_receiver_aliases(tmp_path):
    # the package idiom: `from ..obs import tracing as _obs_tracing`
    findings = _lint(tmp_path, ("recv.py", '''
        def f(_obs_tracing, tracing, name):
            _obs_tracing.trace_span(name)
            tracing.trace_instant(name, offset=1)
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 2


def test_obs_discipline_exempts_the_span_plumbing_itself(tmp_path):
    # obs/tracing.py and obs/flight.py forward name params by design
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    (obs_dir / "tracing.py").write_text(textwrap.dedent('''
        def trace_span(name, **fields):
            return _make(name, fields)
    '''))
    findings = run_paths([tmp_path])
    assert "obs-discipline" not in _rules_fired(findings)


def test_obs_discipline_covers_jit_site_registrations(tmp_path):
    # the recompile sentinel's site names carry the
    # same literal-name contract — device.jit.trace events and the
    # sentinel snapshot key on them
    findings = _lint(tmp_path, ("js.py", '''
        def f(jit_site, _jit_site, kernel, name):
            a = jit_site(name, kernel)
            b = _jit_site("ops." + name, kernel)
            return a, b
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 2


def test_obs_discipline_clean_on_literal_jit_site_names(tmp_path):
    assert _lint(tmp_path, ("jsok.py", '''
        def f(jit_site, kernel):
            return jit_site("ops.blake2b.packed", kernel)
    ''')) == []


def test_obs_discipline_matches_device_receiver_aliases(tmp_path):
    # the package idiom: `from ..obs import device as _obs_device`
    findings = _lint(tmp_path, ("devrecv.py", '''
        def f(_obs_device, device, kernel, name):
            _obs_device.jit_site(name, kernel)
            device.emit(name, x=1)
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 2


def test_obs_discipline_exempts_the_device_plumbing_itself(tmp_path):
    # obs/device.py forwards site/component names by design
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    (obs_dir / "device.py").write_text(textwrap.dedent('''
        def jit_site(name, fn):
            return _JitSite(name, fn)
    '''))
    findings = run_paths([tmp_path])
    assert "obs-discipline" not in _rules_fired(findings)


def test_obs_discipline_ignores_unrelated_emit_and_histogram_apis(tmp_path):
    # same method NAMES on non-telemetry receivers: logging handlers,
    # sockets, numpy — none of these touch the obs registry
    findings = _lint(tmp_path, ("other.py", '''
        def f(handler, sock, np, record, event, data, bins):
            handler.emit(record)
            sock.emit(event, data)
            np.histogram(data, bins)
    '''))
    assert "obs-discipline" not in _rules_fired(findings)


def test_obs_discipline_covers_loopprof_phase_accounting(tmp_path):
    # phase names key the edge.turn.* histogram family, the
    # turn-span fields, and loopdoctor's attribution — same greppable
    # contract as metric names
    findings = _lint(tmp_path, ("lp.py", '''
        def f(prof, profiler, which, sess, dt, n):
            prof.phase(which, dt)
            profiler.account("over" + which, sess.key, dt, n)
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 2


def test_obs_discipline_clean_on_literal_loopprof_phases(tmp_path):
    # the SESSION argument of account() is runtime by design (a
    # collector label, like a watermark LINK) — only the PHASE is held
    # to the literal contract
    assert _lint(tmp_path, ("lpok.py", '''
        def f(prof, sess, dt, n):
            prof.phase("accept", dt)
            prof.account("read", sess.key, dt, n)
            prof.account("overload-ladder", sess.key, dt, 0)
    ''')) == []


def test_obs_discipline_ignores_unrelated_phase_apis(tmp_path):
    # `phase`/`account` on non-telemetry receivers: a state machine's
    # phase setter, a billing API — out of scope
    findings = _lint(tmp_path, ("phother.py", '''
        def f(machine, billing, next_phase, user, amount):
            machine.phase(next_phase)
            billing.account(user, amount)
    '''))
    assert "obs-discipline" not in _rules_fired(findings)


def test_obs_discipline_exempts_the_loopprof_plumbing_itself(tmp_path):
    # obs/loopprof.py accumulates forwarded phase names by design —
    # the greppable literals live at the edge-loop call sites
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    (obs_dir / "loopprof.py").write_text(textwrap.dedent('''
        def account(prof, name, session, seconds, nbytes):
            prof.phase(name, seconds)
    '''))
    findings = run_paths([tmp_path])
    assert "obs-discipline" not in _rules_fired(findings)


def test_obs_discipline_exempts_the_propagation_plumbing_itself(tmp_path):
    # obs/propagation.py renders labeled divergence gauge
    # names from board state and forwards event payloads — plumbing;
    # the greppable `gossip.*` literals live at its own call sites
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    (obs_dir / "propagation.py").write_text(textwrap.dedent('''
        def _collect(links):
            return {f"cluster.divergence{{replica={r},peer={p}}}": v
                    for (r, p), v in links.items()}

        def record_exchange(board, emit, name, **fields):
            emit(name, **fields)
    '''))
    findings = run_paths([tmp_path])
    assert "obs-discipline" not in _rules_fired(findings)


def test_obs_discipline_still_covers_propagation_call_sites(tmp_path):
    # the exemption is the module, not the plane: a CALLER forwarding
    # a runtime event name still trips the rule
    findings = _lint(tmp_path, ("exchange_site.py", '''
        def lit_exchange(emit, name):
            emit(name, peer="r1")
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 1


def test_obs_discipline_clean_on_literal_wirecost_classes(tmp_path):
    # the wire cost plane: the CLASS argument of account()
    # is the greppable vocabulary; the LINK is a collector label,
    # runtime by design (same split as loopprof's phase vs session)
    assert _lint(tmp_path, ("wcok.py", '''
        def f(wirecost, link, payload, framing):
            wirecost.account("change", link, "tx", payload, framing)
            wirecost.account("change_batch", link, "rx", payload, framing)
    ''')) == []


def test_obs_discipline_wirecost_class_must_be_literal(tmp_path):
    # a forwarded class name breaks the grep contract exactly like a
    # forwarded metric name: one finding per call site
    findings = _lint(tmp_path, ("wcbad.py", '''
        def f(wirecost, cls, link, payload, framing):
            wirecost.account(cls, link, "tx", payload, framing)
    '''))
    assert sum(f.rule == "obs-discipline" for f in findings) == 1


def test_obs_discipline_exempts_the_wirecost_plumbing_itself(tmp_path):
    # obs/wirecost.py renders labeled counter names from ledger state
    # and forwards the class through its module-level helpers —
    # plumbing; the greppable class literals live at the choke points
    obs_dir = tmp_path / "obs"
    obs_dir.mkdir()
    (obs_dir / "wirecost.py").write_text(textwrap.dedent('''
        def account(board, cls, link, payload, framing):
            board.account(cls, link, "tx", payload, framing)

        def _collect(links):
            return {f"wire.cost.bytes{{link={l},class={c}}}": v
                    for (l, c), v in links.items()}
    '''))
    findings = run_paths([tmp_path])
    assert "obs-discipline" not in _rules_fired(findings)


# -- hub-isolation (the shared-engine structural invariants) -------

# the pre-discipline shape: a device dispatch while the hub lock is
# held — every co-resident session's submit convoys behind the device
HUB_LOCK_BAD = '''
class Hub:
    def turn(self):
        with self._lock:
            batch = self._compose()
            self._pipeline.dispatch()
            self._pipeline.flush()
'''

HUB_LOCK_GOOD = '''
class Hub:
    def turn(self):
        with self._lock:
            batch = self._compose()
        self._pipeline.dispatch()
        self._pipeline.flush()
'''

# per-session state reached around the session-keyed accessor
HUB_ACCESSOR_BAD = '''
class Hub:
    def shed(self, key):
        self._sessions[key].shed = "parked-budget"
'''

HUB_ACCESSOR_GOOD = '''
class Hub:
    def _session_state(self, key):
        return self._sessions[key]

    def shed(self, key):
        self._session_state(key).shed = "parked-budget"
'''


def _lint_hub(tmp_path, name, source):
    hub_dir = tmp_path / "hub"
    hub_dir.mkdir(exist_ok=True)
    (hub_dir / name).write_text(textwrap.dedent(source))
    return run_paths([tmp_path])


def test_hub_isolation_fires_on_dispatch_under_lock(tmp_path):
    findings = _lint_hub(tmp_path, "locked.py", HUB_LOCK_BAD)
    hub = [f for f in findings if f.rule == "hub-isolation"]
    assert len(hub) == 2  # dispatch AND flush under the lock
    assert all("with-lock" in f.message for f in hub)


def test_hub_isolation_clean_on_compose_then_dispatch(tmp_path):
    findings = _lint_hub(tmp_path, "clean.py", HUB_LOCK_GOOD)
    assert "hub-isolation" not in _rules_fired(findings)


def test_hub_isolation_covers_engine_closures_and_device_put(tmp_path):
    # hash_begin()/collect() closures and raw device_put are dispatches
    # too, whatever object they hang off
    findings = _lint_hub(tmp_path, "closures.py", '''
        class Hub:
            def turn(self, jax, engine):
                with self.hub_lock:
                    collect = engine.hash_begin(self.payloads)
                    jax.device_put(self.batch)
                    collect()
    ''')
    hub = [f for f in findings if f.rule == "hub-isolation"]
    assert len(hub) == 3  # hash_begin + device_put + the collect() call


def test_hub_isolation_fires_on_raw_sessions_subscript(tmp_path):
    findings = _lint_hub(tmp_path, "subs.py", HUB_ACCESSOR_BAD)
    hub = [f for f in findings if f.rule == "hub-isolation"]
    assert len(hub) == 1 and "session-keyed accessor" in hub[0].message


def test_hub_isolation_clean_via_accessor(tmp_path):
    findings = _lint_hub(tmp_path, "acc.py", HUB_ACCESSOR_GOOD)
    assert "hub-isolation" not in _rules_fired(findings)


def test_hub_isolation_scoped_to_hub_directories(tmp_path):
    # the same shapes OUTSIDE hub/ are other modules' business
    findings = _lint(tmp_path, ("elsewhere.py", HUB_LOCK_BAD))
    assert "hub-isolation" not in _rules_fired(findings)


def test_hub_isolation_suppression(tmp_path):
    findings = _lint_hub(tmp_path, "sup.py", '''
        class Hub:
            def turn(self):
                with self._lock:
                    # datlint: disable=hub-isolation
                    self._pipeline.flush()
    ''')
    assert "hub-isolation" not in _rules_fired(findings)


# -- fanout-hot-path (the O(1)-writer broadcast contract) ----------

# the regression shape: a "small" per-peer notification loop (and a
# per-peer copy) inside publish — every produced byte back to O(peers)
FANOUT_WRITER_BAD = '''
class Server:
    def publish(self, data):
        self.log.append(data)
        for peer in self._peers.values():
            peer.pending += bytes(data)
            peer.notify()
'''

# the shipped shape: append/publish do O(1) bookkeeping; the dispatcher
# owns per-peer iteration
FANOUT_WRITER_GOOD = '''
class Server:
    def publish(self, data):
        self.log.append(data)
        self._marks.append((self.log.end, self.now()))

    def _dispatch_turn(self):
        for peer in self._peers.values():
            self.serve(peer)
'''


def _lint_fanout(tmp_path, name, source):
    fdir = tmp_path / "fanout"
    fdir.mkdir(exist_ok=True)
    (fdir / name).write_text(textwrap.dedent(source))
    return run_paths([tmp_path])


def test_fanout_hot_path_fires_on_per_peer_loop_in_publish(tmp_path):
    findings = _lint_fanout(tmp_path, "loop.py", FANOUT_WRITER_BAD)
    hits = [f for f in findings if f.rule == "fanout-hot-path"]
    # the loop itself, plus the peer-state reaches inside it
    assert hits and any("O(1) in peers" in f.message for f in hits)


def test_fanout_hot_path_clean_on_o1_writer(tmp_path):
    findings = _lint_fanout(tmp_path, "clean.py", FANOUT_WRITER_GOOD)
    assert "fanout-hot-path" not in _rules_fired(findings)


def test_fanout_hot_path_fires_on_peer_state_reach_without_loop(tmp_path):
    findings = _lint_fanout(tmp_path, "reach.py", '''
        class Log:
            def append(self, data):
                self._buf += data
                self._cursors["head"].wake()
    ''')
    hits = [f for f in findings if f.rule == "fanout-hot-path"]
    assert len(hits) == 1
    assert "per-peer state" in hits[0].message


def test_fanout_hot_path_fires_on_comprehension_allocation(tmp_path):
    findings = _lint_fanout(tmp_path, "comp.py", '''
        class Server:
            def publish(self, data):
                self.slabs = [bytes(data) for _ in range(2)]
    ''')
    hits = [f for f in findings if f.rule == "fanout-hot-path"]
    assert hits and "loop" in hits[0].message


def test_fanout_hot_path_scoped_to_fanout_directories(tmp_path):
    # the same shapes OUTSIDE fanout/ are other modules' business
    findings = _lint(tmp_path, ("elsewhere.py", FANOUT_WRITER_BAD))
    assert "fanout-hot-path" not in _rules_fired(findings)


def test_fanout_hot_path_ignores_non_writer_functions(tmp_path):
    findings = _lint_fanout(tmp_path, "dispatcher.py", '''
        class Server:
            def _dispatch_turn(self):
                for key in list(self._peers):
                    self._serve(self._peer_state(key))
    ''')
    assert "fanout-hot-path" not in _rules_fired(findings)


def test_fanout_hot_path_suppression(tmp_path):
    findings = _lint_fanout(tmp_path, "sup.py", '''
        class Server:
            def publish(self, data):
                self.log.append(data)
                # one-shot attach barrier, measured O(1) amortized
                # datlint: disable=fanout-hot-path
                for peer in self._warm_peers:
                    peer.prime()
    ''')
    assert "fanout-hot-path" not in _rules_fired(findings)


# Snapshot bootstrap constants: the negotiation trio (frame
# type / capability bit / payload version) plus the weighted-
# participation constants written down independently in ops/rateless.py
# and the native dat_rateless_build_w twin — a participation fork is a
# route fork (two engines mapping the same chunk to different cells, a
# chunk-set reconcile that silently never decodes).
SNAPSHOT_PY = '''
TYPE_SNAPSHOT = 5
CAP_SNAPSHOT = 4
SNAPSHOT_VERSION = 1
RATELESS_W_SHIFT = 12
RATELESS_W_CAP = 8
'''

SNAPSHOT_C_GOOD = '''
// wire: TYPE_SNAPSHOT = 5
// wire: SNAPSHOT_VERSION = 1
// wire: RATELESS_W_SHIFT = 12
// wire: RATELESS_W_CAP = 8
'''


def test_wire_parity_covers_snapshot_constants(tmp_path):
    bad = SNAPSHOT_C_GOOD.replace(
        "TYPE_SNAPSHOT = 5", "TYPE_SNAPSHOT = 6").replace(
        "RATELESS_W_SHIFT = 12", "RATELESS_W_SHIFT = 13")
    findings = _lint(tmp_path, ("snapshot.py", SNAPSHOT_PY),
                     ("native.cpp", bad))
    drift = [f for f in findings if f.rule == "wire-constant-parity"]
    assert {m.split("wire constant ")[1].split(" ")[0] for m in
            (f.message for f in drift)} == {"TYPE_SNAPSHOT",
                                            "RATELESS_W_SHIFT"}


def test_wire_parity_snapshot_constants_clean_when_agreeing(tmp_path):
    assert _lint(tmp_path, ("snapshot.py", SNAPSHOT_PY),
                 ("native.cpp", SNAPSHOT_C_GOOD)) == []


def test_wire_parity_weighted_cap_python_python_drift(tmp_path):
    findings = _lint(tmp_path, ("a.py", "RATELESS_W_CAP = 8\n"),
                     ("b.py", "RATELESS_W_CAP = 9\n"))
    assert _rules_fired(findings) == {"wire-constant-parity"}


# Wire-pump scanner constants: the native pump shares
# dat_split_frames itself (one scanner — no framing fork by
# construction), but its receive entry restates the header-capacity
# floor as a `// wire:` marker (a slab smaller than one maximal header
# could never make progress at a frame boundary).  The pump-parity
# fixture: a scanner fork is a route fork — a pump-side framing
# constant drifting from wire/framing.py must be a finding, so the
# Python reference pump cannot drift silently behind the native one.
PUMP_PY = '''
MAX_VARINT_LEN = 10
MAX_HEADER_LEN = MAX_VARINT_LEN + 1
'''

PUMP_C_GOOD = '''
// the pump's minimum slab capacity:  // wire: MAX_HEADER_LEN = 11
if (cap < 11 || slice < 1) return DAT_ERR_CAPACITY;
'''


def test_wire_parity_covers_pump_scanner_constant(tmp_path):
    bad = PUMP_C_GOOD.replace("MAX_HEADER_LEN = 11",
                              "MAX_HEADER_LEN = 12")
    findings = _lint(tmp_path, ("framing.py", PUMP_PY),
                     ("native.cpp", bad))
    drift = [f for f in findings if f.rule == "wire-constant-parity"]
    assert {m.split("wire constant ")[1].split(" ")[0] for m in
            (f.message for f in drift)} == {"MAX_HEADER_LEN"}


def test_wire_parity_pump_scanner_clean_when_agreeing(tmp_path):
    assert _lint(tmp_path, ("framing.py", PUMP_PY),
                 ("native.cpp", PUMP_C_GOOD)) == []


# -- structured-error-parity (cluster errors carry context) -------

# the pre-contract shape: an error type naming neither the peer nor the
# wire coordinates — a byzantine post-mortem reduced to "something
# failed somewhere"
STRUCTERR_BAD = '''
class GossipBroken(RuntimeError):
    def __init__(self, message):
        super().__init__(message)
'''

STRUCTERR_GOOD = '''
class GossipBroken(RuntimeError):
    def __init__(self, message, *, peer, frame=None, offset=None):
        super().__init__(message)
        self.peer = peer
        self.frame = frame
        self.offset = offset
'''


def _lint_cluster(tmp_path, source, rules=("structured-error-parity",)):
    from dat_replication_protocol_tpu_torch.analysis.rules import ALL_RULES

    pkg = tmp_path / "cluster"
    pkg.mkdir(exist_ok=True)
    (pkg / "err.py").write_text(textwrap.dedent(source))
    return run_paths([tmp_path],
                     rules=[r for r in ALL_RULES if r.name in rules])


def test_structured_error_parity_fires_on_bare_error(tmp_path):
    findings = _lint_cluster(tmp_path, STRUCTERR_BAD)
    assert _rules_fired(findings) == {"structured-error-parity"}
    assert "peer" in findings[0].message


def test_structured_error_parity_fires_on_missing_init(tmp_path):
    findings = _lint_cluster(tmp_path, '''
class GossipBroken(RuntimeError):
    pass
''')
    assert _rules_fired(findings) == {"structured-error-parity"}
    assert "__init__" in findings[0].message


def test_structured_error_parity_clean_on_full_context(tmp_path):
    assert _lint_cluster(tmp_path, STRUCTERR_GOOD) == []


def test_structured_error_parity_accepts_self_assignments(tmp_path):
    # offset/frame may be explicit self assignments instead of
    # pass-through parameters
    assert _lint_cluster(tmp_path, '''
class GossipBroken(Exception):
    def __init__(self, peer):
        super().__init__(peer)
        self.peer = peer
        self.offset = 0
        self.frame = None
''') == []


def test_structured_error_parity_scoped_to_cluster_dirs(tmp_path):
    # the same bare error OUTSIDE a cluster/ directory is not this
    # rule's business
    (tmp_path / "other.py").write_text(textwrap.dedent(STRUCTERR_BAD))
    findings = _lint(tmp_path, ("other.py", STRUCTERR_BAD),
                     rules=None)
    assert "structured-error-parity" not in _rules_fired(findings)


def test_structured_error_parity_suppressible(tmp_path):
    src = STRUCTERR_BAD.replace(
        "class GossipBroken(RuntimeError):",
        "class GossipBroken(RuntimeError):  "
        "# datlint: disable=structured-error-parity")
    assert _lint_cluster(tmp_path, src) == []


def test_structured_error_parity_non_error_classes_exempt(tmp_path):
    assert _lint_cluster(tmp_path, '''
class ReplicaThing:
    def __init__(self):
        self.x = 1
''') == []


# -- the port's permitted differences -------------------------------------------

GEAR_PY = """
_GEAR_C1 = 0x9E3779B1
_GEAR_C2 = 0x85EBCA77
"""


def test_difference_cuda_sources_are_read_as_c(tmp_path):
    # .cu/.cuh are the port's C translation units: their wire constants
    # are held to the Python ones; the JAX package's engine skips them
    (tmp_path / "rabin.py").write_text(GEAR_PY)
    (tmp_path / "gear.cuh").write_text(
        "constexpr uint32_t GEAR_C1 = 0x9E3779B3;\n"
        "constexpr uint32_t GEAR_C2 = 0x85EBCA77;\n")
    (tmp_path / "k.cu").write_text("// datlint: disable=wire-constant-parity"
                                   "\nint x;\n")
    port = port_paths([tmp_path])
    assert [(f.rule, f.path.endswith("gear.cuh") or f.path.endswith(
        "rabin.py")) for f in port if f.rule == "wire-constant-parity"] \
        == [("wire-constant-parity", True)]
    # the unused marker in k.cu is read, and judged stale
    assert any(f.rule == "stale-suppression" and f.path.endswith("k.cu")
               for f in port)
    assert reference_findings([tmp_path]) == []


WIRE_NO_BULK = ("decoder.py", '''
    from framing import TYPE_BLOB, TYPE_CHANGE

    def trace(kind):
        pass

    class Decoder:
        def __init__(self):
            self.changes = 0
            self.blobs = 0

        def _scan_header(self, type_id):
            if type_id == TYPE_CHANGE:
                trace(kind="change")
            elif type_id == TYPE_BLOB:
                trace(kind="blob")

        def _frames_delivered(self):
            return self.changes + self.blobs
''')
WIRE_FRAMING = ("framing.py", '''
    TYPE_HEADER = 0
    TYPE_CHANGE = 1
    TYPE_BLOB = 2
    KNOWN_TYPES = (TYPE_CHANGE, TYPE_BLOB)
''')


def test_difference_bulk_index_surface_only_where_defined(tmp_path):
    from dat_replication_protocol_tpu_torch.analysis.rules.wire_dispatch \
        import WireDispatchParity

    for name, source in (WIRE_FRAMING, WIRE_NO_BULK):
        (tmp_path / name).write_text(textwrap.dedent(source))
    rules = [WireDispatchParity()]
    assert port_paths([tmp_path], rules) == []
    ref = reference_findings([tmp_path], rules)
    assert len(ref) == 1 and "_run_indexed" in ref[0].message \
        and "lost its anchor" in ref[0].message
    # losing the scanner anchor stays loud on both
    (tmp_path / "decoder.py").write_text(textwrap.dedent(
        WIRE_NO_BULK[1]).replace("_scan_header", "_scan_hdr"))
    port = port_paths([tmp_path], rules)
    assert any("_scan_header" in f.message and "lost its anchor"
               in f.message for f in port)


def test_difference_hub_isolation_counts_synchronize_as_dispatch(tmp_path):
    src = '''
        import threading
        import torch

        class Hub:
            def __init__(self):
                self._lock = threading.Lock()

            def drain(self, ev):
                with self._lock:
                    ev.synchronize()
                    torch.cuda.synchronize()
    '''
    hub = tmp_path / "hub"
    hub.mkdir()
    (hub / "engine.py").write_text(textwrap.dedent(src))
    from dat_replication_protocol_tpu_torch.analysis.rules.hub_isolation \
        import HubIsolation

    rules = [HubIsolation()]
    port = port_paths([tmp_path], rules)
    assert [f.line for f in port] == [11, 12]
    assert all("synchronize" in f.message for f in port)
    assert reference_findings([tmp_path], rules) == []


def test_difference_native_pumps_are_not_entry_points(tmp_path):
    from dat_replication_protocol_tpu.analysis.concurrency import (
        ReadinessIndex as RefIndex,
        render_event_loop_surface as ref_render,
    )
    from dat_replication_protocol_tpu.analysis.engine import \
        Project as RefProject
    from dat_replication_protocol_tpu_torch.analysis.concurrency import (
        ReadinessIndex,
        render_event_loop_surface,
    )
    from dat_replication_protocol_tpu_torch.analysis.engine import Project

    (tmp_path / "x.py").write_text("X = 1\n")
    port = render_event_loop_surface(
        ReadinessIndex.get(Project.from_paths([tmp_path])))
    ref = ref_render(RefIndex.get(RefProject.from_paths([tmp_path])))
    port_missing = {m["entry"] for m in port["missing_entry_points"]}
    ref_missing = {m["entry"] for m in ref["missing_entry_points"]}
    assert ref_missing - port_missing == {"native-send-pump",
                                          "native-recv-pump"}
    assert port_missing < ref_missing


def test_difference_cli_and_generators_name_the_port(tmp_path, capsys):
    (tmp_path / "l.py").write_text("X = 1\n")
    out = tmp_path / "art"
    assert datlint_main(["--write-artifacts", str(out), str(tmp_path)]) == 0
    capsys.readouterr()
    for name in ("lock_graph.json", "event_loop_surface.json"):
        doc = json.loads((out / name).read_text())
        assert doc["generator"].startswith(
            "python -m dat_replication_protocol_tpu_torch.analysis ")
    with pytest.raises(SystemExit):
        datlint_main(["--help"])
    assert "python -m dat_replication_protocol_tpu_torch.analysis" \
        in capsys.readouterr().out


def test_parity_helper_catches_a_disagreement(tmp_path):
    # the differential check itself must bite: the same fixture as the
    # bulk-index difference, where the analyzers part, fails run_paths
    for name, source in (WIRE_FRAMING, WIRE_NO_BULK):
        (tmp_path / name).write_text(textwrap.dedent(source))
    with pytest.raises(AssertionError, match="disagree"):
        run_paths([tmp_path])
    assert rows(port_paths([tmp_path]), [tmp_path]) != rows(
        reference_findings([tmp_path]), [tmp_path])

