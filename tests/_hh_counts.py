"""The counters of one ``qr(a)`` as the drivers and the plans give them,
for the tests that hold the counters to them: the hh path's
(``planned_hh_counts``; the CPU tests through a stubbed kernel library,
the card test at 16384²) and the hr path's (``planned_hr_counts``; the
plain versions' counts on the CPU, the launches on the card). Imported as
``_hh_counts`` (pytest puts ``tests/`` on the path): a ``tests`` package
installed beside the project would shadow ``tests._hh_counts``."""

import torch

from tileqr_torch.core.layout import round_up
from tileqr_torch.core.trace import HR_APPLY
from tileqr_torch.drivers import square
from tileqr_torch.drivers.square_hr import _apply_route
from tileqr_torch.kernels import chain, panel, panel_apply
from tileqr_torch.kernels.common import counter_key, passes_of


def planned_hh_counts(n: int, nb: int, ib: int, chunk: int, sms: int, side: bool = True,
                      precision: str = "highest") -> dict:
    """The counters of one hh ``qr(a)`` (reduced) on an n×n A (n a multiple
    of nb, nb > ib), derived from the driver's segments
    (``square._segments``) and the plans: ``trace.LOOKAHEAD`` (``side``: a
    card, where panels run on the side stream), ``_build.PIPELINE`` and
    ``_build.EXCHANGE`` from ``panel.pipeline_plan`` (K1 + K2 in one launch
    where a panel has chunks, K1 alone where it has heads only, the lone
    GEQRT on the serial loop), ``_build.STRIP`` from ``chain.strip_plan``
    (the factor's narrow and rest updates, then Q's formation, panel k on
    columns k onward; each sweep heads, then chunks, or K4 alone),
    ``_build.CHAIN`` from the same plans' row bands ("chain") and the K4
    launches ("k4")."""
    assert n % nb == 0 and nb > ib
    nt = n // nb
    c = square._chunk_for(nt, chunk)
    pipe = {"launches": 0, "overlapped_steps": 0}
    exchange = {"launches": 0, "columns": 0}
    strip = {}
    bands = {}
    k4 = 0

    def sweep(k, width):
        nonlocal k4
        n_head, _, nc = square._segments(k, nt, c)
        calls = [(cp, rows) for cp, rows in ((n_head, nb), (nc, c * nb)) if cp]
        k4 += not calls
        for couples, rows in calls:
            p = chain.strip_plan(nb, width, rows, couples, sms, precision)
            e = strip.setdefault((p.proj_tile, p.groups, p.sub_tile),
                                 {"launches": 0, "couples": 0})
            e["launches"] += 1
            e["couples"] += couples
            e = bands.setdefault(p.bands, {"launches": 0, "couples": 0})
            e["launches"] += 1
            e["couples"] += couples

    for k in range(nt):
        n_head, _, nc = square._segments(k, nt, c)
        steps = 1 + n_head + nc
        rows = nb + c * nb if nc else (2 * nb if n_head else nb)
        plan = panel.pipeline_plan(nb, ib, steps, rows)
        pipe["launches"] += plan.stages > 1
        pipe["overlapped_steps"] += (steps - 1) * (plan.stages > 1)
        if plan.cluster.ctas > 1:
            exchange["launches"] += 1
            exchange["columns"] += steps * nb
        left = nt - k - 1
        if left:
            sweep(k, nb if left >= 2 else left * nb)
        if left >= 2:
            sweep(k, (left - 1) * nb)
    for k in range(nt - 1, -1, -1):
        sweep(k, (nt - k) * nb)
    split = max(0, nt - 2)
    return {"lookahead": {"split": split, "beside": split if side else 0},
            "pipeline": pipe, "exchange": exchange, "strip": strip, "chain": bands,
            "k4": k4}


def planned_hr_counts(m: int, n: int, nb: int, precision: str = "highest",
                      sms: int = 132) -> dict:
    """What one ``qr(a, mode="reduced")`` on an (m, n) fp32 A counts on the
    hr path when the guard holds, from the shapes alone: "panels" of the
    padded matrix (``square_hr.pad_for_hr``: columns to nb, rows past the
    identity block where columns were padded); "launches", the kernel
    launches on the card by ``_build.LAUNCHES`` key (B9 and B8 a panel, B6
    a panel with columns right of it, B7 on the applies that take it; on
    the CPU the plain versions count the same calls in ``PLAIN_CALLS``);
    "hr_apply", ``trace.HR_APPLY`` over Q's formation (``orgqr_hr``'s
    window, panel k on rows and columns ≥ k·nb); "project",
    ``_build.PROJECT`` on a card of ``sms`` SMs (an H100's 132 by
    default): B6's and B7's fp32 phase-1 launches by their plan's
    schedule (``panel_apply.project_plan``), with the chains handed."""
    np_ = round_up(n, nb)
    mp = round_up(m + np_ - n, nb)
    panels = min(mp, np_) // nb
    ncols = max(min(m, n), 1)
    routes = dict.fromkeys(HR_APPLY, 0)
    # phase 1's (m, n, mr) of each B6 and B7 launch
    phase1 = [(mp - k * nb, np_ - (k + 1) * nb, panel_apply._block(mp - k * nb, nb, 512))
              for k in range(panels) if (k + 1) * nb < np_]
    for k in range(min(panels, -(-ncols // nb))):
        route = _apply_route(mp - k * nb, nb, ncols - k * nb, torch.float32, precision)
        routes[route] += 1
        if route == "b7":
            phase1.append((mp - k * nb, ncols - k * nb, panel_apply._block(mp - k * nb, nb, 1024)))
    launches = {"potrf_batched": panels, "modified_lu": panels,
                counter_key("panel_apply_carry", precision):
                    sum((k + 1) * nb < np_ for k in range(panels)),
                counter_key("panel_apply", precision): routes["b7"]}
    project = {"balanced": 0, "whole_tiles": 0, "handed": 0}
    if not passes_of(precision):
        for rows, cols, mr in phase1:
            plan = panel_apply.project_plan(rows, cols, nb, mr, sms, precision, fold=True)
            project["balanced" if plan.ranges else "whole_tiles"] += 1
            project["handed"] += plan.handed
    return {"panels": panels, "launches": {k: v for k, v in launches.items() if v},
            "hr_apply": routes, "project": project}
