"""Each kernel decision of ``tileqr_torch`` made in one place, on the CPU.

- Every launch plan is two parts in its kernel's module: the rule at a
  given size (``*_plan_at``: the block resident in shared memory where it
  fits, the tiles and G) and the chooser that picks the size and calls it.
  At every shape the plan tests already hold, each chooser's plan equals
  its ``*_plan_at`` at the size it chose.
- Every launch entry of the kernel library (``_build.SIGNATURES``, less
  the size queries) is called from one function of the package, in a
  kernel module, and from nowhere in the tests or the card's smoke run:
  the plan tools and the card tests launch through that function.
- The kernel modules' imports point one way: ``geqrt.py`` (the column loop
  and the cluster routine's plan) imports no kernel module at call time,
  and only ``chain.py`` imports K1's module.
- ``chain.strip_sweep``, the one K3/K4 sweep of the drivers, makes the
  calls the drivers made by hand before it, in their order, for a panel
  with head and chunk couples, with either, or with none, in each
  direction, and the same bits.
"""

import ast
import re
from pathlib import Path

import pytest
import torch

import test_torch_batched_cluster_plan as batched_cases
import test_torch_cluster_plan as cluster_cases
import test_torch_modlu_blocked as modlu_cases
import test_torch_potrf_plan as potrf_cases
import test_torch_project_plan as project_cases
import test_torch_strip_plan as strip_cases
from tileqr_torch.kernels import _build, chain, geqrt, modlu, panel_apply, potrf, ttqrt

H100_SMS = 132
ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "tileqr_torch"


# ---- each chooser's plan is its rule at the size it chose ----

def _cluster(geo):
    p = geqrt.cluster_plan(*geo)
    return p, geqrt.cluster_plan_at(*geo, p.ctas)


def _batched(case):
    b, m, n, ib = case
    p = geqrt.batched_cluster_plan(b, m, n, ib, H100_SMS)
    return p, geqrt.batched_cluster_plan_at(m, n, ib, p.ctas)


def _modlu(nb):
    p = modlu.modlu_plan(nb)
    return p, modlu.modlu_plan_at(nb, p.ctas)


def _potrf(case):
    b, n = case
    p = potrf.potrf_plan(b, n, H100_SMS)
    return p, potrf.potrf_plan_at(b, n, p.ctas)


def _ttqrt(geo):
    p = ttqrt.ttqrt_plan(*geo)
    return p, ttqrt.ttqrt_plan_at(*geo, p.ctas)


def _tall(case):
    b, m, n, ib = case
    p = geqrt.tall_plan(b, m, n, ib, H100_SMS)
    return p, geqrt.tall_plan_at(b, m, n, ib, H100_SMS, p.w)


def _strip(case):
    nb, width, rows, couples, prec, fused = case
    p = chain.strip_plan(nb, width, rows, couples, H100_SMS, prec, fused)
    return p, chain.strip_plan_at(nb, width, rows, couples, p.proj_tile, p.groups, p.sub_tile,
                                  fused, p.bands)


def _project(case):
    m, n, nb, mr, prec, fold = case
    p = panel_apply.project_plan(m, n, nb, mr, H100_SMS, prec, fold)
    return p, panel_apply.project_plan_at(m, n, nb, mr, p.groups, prec, fold, p.ranges)


TALL_SHAPES = [shape for shape, (route, _) in batched_cases.ROUTE_CASES.values()
               if route == "tall"] + [(512, 4096, 512, 128)]
PLANS = ([("cluster", _cluster, geo) for geo in cluster_cases.MAIN + cluster_cases.TESTS]
         + [("batched-cluster", _batched, shape)
            for shape, _ in batched_cases.PLAN_CASES.values()]
         + [("modlu", _modlu, nb) for nb in modlu_cases.MODLU_MAIN + modlu_cases.MODLU_TESTS]
         + [("potrf", _potrf, shape) for shape, _ in potrf_cases.PLAN_CASES.values()]
         + [("ttqrt", _ttqrt, geo) for geo in modlu_cases.TTQRT_MAIN + modlu_cases.TTQRT_TESTS]
         + [("tall", _tall, shape) for shape in TALL_SHAPES]
         + [("strip", _strip, shape) for shape, _ in strip_cases.STRIP_CASES.values()]
         + [("project", _project, shape) for shape, _ in project_cases.PLAN_CASES.values()])


@pytest.mark.parametrize("kind,plans,shape", PLANS,
                         ids=[f"{k}-{'x'.join(map(str, s)) if isinstance(s, tuple) else s}"
                              for k, _, s in PLANS])
def test_chooser_is_the_rule_at_its_size(kind, plans, shape):
    chosen, at_size = plans(shape)
    assert chosen == at_size


def test_every_kernel_is_among_the_plan_cases():
    assert {kind for kind, _, _ in PLANS} == {"cluster", "batched-cluster", "modlu", "potrf",
                                               "ttqrt", "tall", "strip", "project"}


# ---- one launch site per C entry ----

# the library's size queries, called wherever a launch sizes its buffers
QUERY = re.compile(r"_(work_floats|per_sm|grid)$")
LAUNCH_ENTRIES = sorted(name for name in _build.SIGNATURES if not QUERY.search(name))
# utils/cluster_stages.py reads its stage timers through tq_*_stages
# entries of a second, instrumented build: a listed debt, not launches
STAGES_DEBT = re.compile(r"^tq_\w+_stages$")


def _sources():
    return (sorted(PACKAGE.rglob("*.py")) + sorted((ROOT / "tests").glob("*.py"))
            + [ROOT / "chip_smoke.py"])


class _Calls(ast.NodeVisitor):
    """(function, line) of every call ``<x>.tq_<name>(...)`` in a module."""

    def __init__(self):
        self.stack, self.found = ["<module>"], []

    def visit_FunctionDef(self, node):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node):
        if isinstance(node.func, ast.Attribute) and node.func.attr.startswith("tq_"):
            self.found.append((node.func.attr, self.stack[-1], node.lineno))
        self.generic_visit(node)


def _call_sites():
    sites = {}
    for path in _sources():
        calls = _Calls()
        calls.visit(ast.parse(path.read_text(), str(path)))
        for name, fn, line in calls.found:
            sites.setdefault(name, []).append((path.relative_to(ROOT).as_posix(), fn, line))
    return sites


SITES = _call_sites()


def test_launch_entries_are_the_librarys():
    assert "tq_couple_strip" in LAUNCH_ENTRIES and "tq_cluster_work_floats" not in LAUNCH_ENTRIES
    assert len(LAUNCH_ENTRIES) >= 14


@pytest.mark.parametrize("name", LAUNCH_ENTRIES)
def test_one_launch_site(name):
    """The entry is called from exactly one function, in a kernel module."""
    sites = SITES.get(name, [])
    assert len(sites) == 1, sites
    assert sites[0][0].startswith("tileqr_torch/kernels/"), sites


def test_only_known_entries_are_called():
    """Every ``tq_*`` call names a library entry (or the error string, or a
    listed stage timer)."""
    known = set(_build.SIGNATURES) | {"tq_error_string"}
    stray = {n: s for n, s in SITES.items() if n not in known and not STAGES_DEBT.match(n)}
    assert not stray


# ---- the kernel modules' imports point one way ----

def _imports(path):
    """(module, at call time) of each import of a module."""
    out = []
    tree = ast.parse(path.read_text())
    top = {id(node) for node in tree.body}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module + "." + a.name for a in node.names] + [node.module]
            out += [(n, id(node) not in top) for n in names]
        elif isinstance(node, ast.Import):
            out += [(a.name, id(node) not in top) for a in node.names]
    return out


def test_geqrt_imports_nothing_at_call_time():
    assert not [n for n, late in _imports(PACKAGE / "kernels" / "geqrt.py") if late]


@pytest.mark.parametrize("module", sorted(p.name for p in (PACKAGE / "kernels").glob("*.py")))
def test_only_chain_imports_the_panel_module(module):
    names = [n for n, _ in _imports(PACKAGE / "kernels" / module)]
    if module != "chain.py":
        assert "tileqr_torch.kernels.panel" not in names


# ---- one strip sweep ----

NB, CHUNK, COL_START = 4, 2, 1


def _parent_sweep(heads, chunks, vkk, tg, strip, nb, trans, precision):
    """The sweep the drivers (``drivers/square.py`` in ``qr_tiled`` and
    ``apply_q_tiled``, ``drivers/sharded.py:_sweep``) wrote out by hand
    before ``chain.strip_sweep``."""
    if trans:
        if heads:
            chain.couple_strip(*heads, trans=True, vkk=vkk, tg=tg, precision=precision)
            if chunks:
                chain.couple_strip(*chunks, trans=True, precision=precision)
        elif chunks:
            chain.couple_strip(*chunks, trans=True, vkk=vkk, tg=tg, precision=precision)
        else:
            chain.larfb_strip(vkk, tg, strip, nb, trans=True, precision=precision)
        return
    if chunks:
        fuse = dict(vkk=vkk, tg=tg) if not heads else {}
        chain.couple_strip(*chunks, trans=False, reverse=True, precision=precision, **fuse)
    if heads:
        chain.couple_strip(*heads, trans=False, reverse=True, vkk=vkk, tg=tg,
                           precision=precision)
    if not heads and not chunks:
        chain.larfb_strip(vkk, tg, strip, nb, trans=False, precision=precision)


def _panel(n_head, n_chunks, seed):
    """A matrix, its row strip from column tile COL_START and one panel's
    operands: (mat, strip, heads, chunks, vkk, tg)."""
    g = torch.Generator().manual_seed(seed)
    rows = NB * (1 + n_head + CHUNK * n_chunks)
    mat = torch.randn((rows, 3 * NB), generator=g, dtype=torch.float64)
    strip = mat[:NB, COL_START * NB :]
    v_stack = torch.randn((1 + n_head, NB, NB), generator=g, dtype=torch.float64) / NB
    t2h = torch.triu(torch.randn((1 + n_head, NB, NB), generator=g, dtype=torch.float64)) / NB
    v_chunks = torch.randn((n_chunks, CHUNK * NB, NB), generator=g, dtype=torch.float64) / NB
    t2t = torch.triu(torch.randn((n_chunks, NB, NB), generator=g, dtype=torch.float64)) / NB
    tg = torch.triu(torch.randn((NB, NB), generator=g, dtype=torch.float64)) / NB
    heads = (v_stack, t2h, mat, strip, 1, 1, n_head, NB, NB, COL_START) if n_head else None
    base = (1 + n_head) // CHUNK
    chunks = ((v_chunks, t2t, mat, strip, 0, base, n_chunks, CHUNK * NB, NB, COL_START)
              if n_chunks else None)
    return mat, strip, heads, chunks, v_stack[0], tg


def _recorded(monkeypatch, sweep, n_head, n_chunks, trans):
    """Run ``sweep`` on a fresh panel: (its K3/K4 calls in order, the plain
    calls it counted, the matrix after it)."""
    calls = []
    real_k3, real_k4 = chain.couple_strip, chain.larfb_strip

    def k3(*args, **kw):
        calls.append(("K3", "heads" if args[4] == 1 else "chunks", kw.get("vkk") is not None,
                      kw.get("trans", True), kw.get("reverse", False)))
        return real_k3(*args, **kw)

    def k4(*args, **kw):
        calls.append(("K4", None, True, kw.get("trans", True), False))
        return real_k4(*args, **kw)

    monkeypatch.setattr(chain, "couple_strip", k3)
    monkeypatch.setattr(chain, "larfb_strip", k4)
    mat, strip, heads, chunks, vkk, tg = _panel(n_head, n_chunks, 7)
    _build.reset_counts()
    sweep(heads, chunks, vkk, tg, strip, NB, trans, "highest")
    counted = {k: v for k, v in _build.PLAIN_CALLS.items() if v}
    monkeypatch.undo()
    return calls, counted, mat


# (head couples, chunk couples) → the calls forward (trans) and in reverse:
# (kernel, couples, LARFB fused); the heads end on a chunk boundary, as
# the drivers' do
SWEEPS = {
    "heads-and-chunks": ((1, 2), [("K3", "heads", True), ("K3", "chunks", False)],
                         [("K3", "chunks", False), ("K3", "heads", True)]),
    "heads-only": ((3, 0), [("K3", "heads", True)], [("K3", "heads", True)]),
    "chunks-only": ((0, 2), [("K3", "chunks", True)], [("K3", "chunks", True)]),
    "none": ((0, 0), [("K4", None, True)], [("K4", None, True)]),
}


@pytest.mark.parametrize("case", list(SWEEPS))
@pytest.mark.parametrize("trans", [True, False], ids=["forward", "reverse"])
def test_strip_sweep_makes_the_drivers_calls(monkeypatch, case, trans):
    (n_head, n_chunks), forward, reverse = SWEEPS[case]
    got, got_counts, got_mat = _recorded(monkeypatch, chain.strip_sweep, n_head, n_chunks, trans)
    want, want_counts, want_mat = _recorded(monkeypatch, _parent_sweep, n_head, n_chunks, trans)
    assert got == want
    assert [c[:3] for c in got] == (forward if trans else reverse)
    assert all(c[3] == trans and c[4] == (not trans and c[0] == "K3") for c in got)
    assert got_counts == want_counts
    assert sum(got_counts.values()) == len(got)
    assert torch.equal(got_mat, want_mat)
