"""Logical -> physical planning (port of the reference package's
`sql/planner.py`).

The logical tree lowers to the ExecutionPlan IR of plan/. Responsibilities:

- scan column pruning (only columns referenced anywhere above reach HBM),
- materializing group/agg/sort/join-key expressions into named columns,
- COUNT(DISTINCT x) -> two-level aggregate rewrite,
- resolving uncorrelated scalar subqueries into lazily-executed constants,
- capacity/slot policy via PlannerConfig (join expansion, agg load factor).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Optional, Sequence

from datafusion_distributed_tpu_torch.ops.aggregate import AggSpec
from datafusion_distributed_tpu_torch.ops.sort import SortKey
from datafusion_distributed_tpu_torch.ops.table import round_up_pow2
from datafusion_distributed_tpu_torch.plan import expressions as pe
from datafusion_distributed_tpu_torch.plan.joins import (
    CrossJoinExec,
    HashJoinExec,
    UnionExec,
)
from datafusion_distributed_tpu_torch.plan.physical import (
    ExecutionPlan,
    FilterExec,
    HashAggregateExec,
    LimitExec,
    ProjectionExec,
    SortExec,
)
from datafusion_distributed_tpu_torch.schema import DataType, Field, Schema
from datafusion_distributed_tpu_torch.sql import logical as lg

_TMP = itertools.count()


@dataclass
class PlannerConfig:
    join_expansion_factor: float = 1.0
    agg_slot_factor: float = 2.0
    max_slots: int = 1 << 21
    max_out_capacity: int = 1 << 22


class PhysicalPlanner:
    def __init__(self, catalog, config: Optional[PlannerConfig] = None,
                 subquery_executor=None):
        self.catalog = catalog
        self.config = config or PlannerConfig()
        # Scalar subqueries must run under the SAME execution mode as the
        # main query: float aggregation order differs between single-node and
        # distributed plans, and TPC-H q15's `total_revenue = (select max..)`
        # equality only holds when both sides sum in the same order.
        self.subquery_executor = subquery_executor

    # -- public ---------------------------------------------------------------
    def plan(self, logical: lg.LogicalPlan) -> ExecutionPlan:
        used = _collect_used_columns(logical)
        return self._plan(logical, used)

    # -- dispatch ---------------------------------------------------------------
    def _plan(self, node: lg.LogicalPlan, used: set) -> ExecutionPlan:
        if isinstance(node, lg.LScan):
            return self._plan_scan(node, used)
        if isinstance(node, lg.LFilter):
            child = self._plan(node.child, used)
            self._resolve_subqueries(node.predicate)
            f = FilterExec(node.predicate, child)
            # NDV-backed selectivity (replaces the cost model's blanket 1/3
            # for equality/IN predicates; consumed by statistics.estimate_rows)
            f.est_selectivity = self._predicate_selectivity(
                node.predicate, node.child
            )
            return f
        if isinstance(node, lg.LProject):
            child = self._plan(node.child, used)
            for e, _ in node.exprs:
                self._resolve_subqueries(e)
            return ProjectionExec([(e, n) for e, n in node.exprs], child)
        if isinstance(node, lg.LAggregate):
            return self._plan_aggregate(node, used)
        if isinstance(node, lg.LJoin):
            return self._plan_join(node, used)
        if isinstance(node, lg.LSort):
            return self._plan_sort(node, used)
        if isinstance(node, lg.LLimit):
            child = self._plan(node.child, used)
            return LimitExec(child, node.fetch if node.fetch is not None else
                             child.output_capacity(), node.skip)
        if isinstance(node, lg.LDistinct):
            child = self._plan(node.child, used)
            return self._distinct(child)
        if isinstance(node, lg.LSetOp):
            return self._plan_setop(node, used)
        if isinstance(node, lg.LWindow):
            return self._plan_window(node, used)
        raise NotImplementedError(f"cannot lower {type(node).__name__}")

    def _plan_window(self, node: "lg.LWindow", used: set) -> ExecutionPlan:
        from datafusion_distributed_tpu_torch.ops.sort import SortKey
        from datafusion_distributed_tpu_torch.ops.window import WindowFunc
        from datafusion_distributed_tpu_torch.plan.window_exec import WindowExec
        from datafusion_distributed_tpu_torch.schema import Field

        child = self._plan(node.child, used)
        schema = child.schema()
        passthrough = [(pe.Col(f.name), f.name) for f in schema.fields]
        extra: list = []

        def materialize(e, prefix):
            self._resolve_subqueries(e)
            if isinstance(e, pe.Col):
                return e.name
            nm = f"__{prefix}{next(_TMP)}"
            extra.append((e, nm))
            return nm

        # group window exprs by identical (partition, order) spec: one
        # WindowExec per spec
        groups: dict = {}
        for w in node.exprs:
            part_names = tuple(materialize(p, "wp") for p in w.partition_by)
            order_keys = tuple(
                SortKey(materialize(oe, "wo"), asc,
                        (not asc) if nf is None else nf)
                for oe, asc, nf in w.order_by
            )
            arg_name = None
            if w.arg is not None:
                arg_name = materialize(w.arg, "wa")
            spec = (part_names, order_keys)
            groups.setdefault(spec, []).append((w, arg_name))

        plan: ExecutionPlan = (
            ProjectionExec(passthrough + extra, child) if extra else child
        )
        cs = node.child.schema()
        for (part_names, order_keys), ws in groups.items():
            funcs = [
                WindowFunc(w.func, arg_name, w.name, w.frame)
                for w, arg_name in ws
            ]
            fields = [
                Field(w.name, lg._window_dtype(w, cs), True)
                for w, _ in ws
            ]
            plan = WindowExec(plan, funcs, list(part_names),
                              list(order_keys), fields)
        return plan

    # -- scans ------------------------------------------------------------------
    def _plan_scan(self, node: lg.LScan, used: set) -> ExecutionPlan:
        needed_orig = []
        for f in node.table_schema.fields:
            flat = f"{node.alias}.{f.name}"
            if flat in used:
                needed_orig.append(f.name)
        if not needed_orig:
            needed_orig = [node.table_schema.fields[0].name]
        scan = self.catalog.scan_exec(node.table, needed_orig)
        rename = [
            (pe.Col(orig), f"{node.alias}.{orig}") for orig in needed_orig
        ]
        return ProjectionExec(rename, scan)

    # -- aggregate ----------------------------------------------------------------
    def _plan_aggregate(self, node: lg.LAggregate, used: set) -> ExecutionPlan:
        child = self._plan(node.child, used)
        distinct_aggs = [a for a in node.aggs if a.distinct]
        regular = [a for a in node.aggs if not a.distinct]

        # materialize group + agg input expressions
        mat: list = []
        group_names = []
        for e, name in node.groups:
            self._resolve_subqueries(e)
            mat.append((e, name))
            group_names.append(name)
        specs: list[AggSpec] = []
        for a in node.aggs:
            if a.func == "count_star":
                specs.append(AggSpec("count_star", None, a.name))
                continue
            self._resolve_subqueries(a.arg)
            in_name = f"__in_{a.name}"
            mat.append((a.arg, in_name))
            specs.append(AggSpec(a.func, in_name, a.name))
        proj = ProjectionExec(mat, child) if mat else child

        if distinct_aggs and regular:
            # Mixed DISTINCT + plain aggregates (TPC-DS q28/q94/q95,
            # ClickBench q9/q22): each part aggregates independently over
            # the same child; parts stitch back via a 1:1 join on the group
            # keys (global: cross join of 1-row results). A projection
            # restores the original output order.
            from datafusion_distributed_tpu_torch.plan.joins import (
                CrossJoinExec, HashJoinExec,
            )
            from datafusion_distributed_tpu_torch.plan import expressions as pe

            by_name = dict(zip([a.name for a in node.aggs], specs))
            plain_specs = [by_name[a.name] for a in regular]
            groups_ndv = self._exprs_ndv(node.child,
                                         [e for e, _ in node.groups],
                                         loose=True)
            slots = self._agg_slots(proj.output_capacity(), groups_ndv,
                                    child=proj)
            base_slots = 16 if not group_names else slots
            combined = HashAggregateExec(
                "single", group_names, plain_specs, proj, base_slots
            )
            if groups_ndv and group_names:
                combined.est_rows = float(groups_ndv)
            for i, a in enumerate(distinct_aggs):
                s = by_name[a.name]
                dedup_ndv = self._exprs_ndv(
                    node.child, [e for e, _ in node.groups] + [a.arg],
                    loose=True,
                )
                dedup = HashAggregateExec(
                    "single", group_names + [s.input_name], [], proj,
                    self._agg_slots(proj.output_capacity(), dedup_ndv, child=proj),
                )
                cnt = HashAggregateExec(
                    "single", group_names,
                    [AggSpec("count", s.input_name, s.output_name)],
                    dedup, base_slots,
                )
                if not group_names:
                    combined = CrossJoinExec(combined, cnt, out_capacity=16)
                    continue
                # rename build-side group keys to avoid name collisions in
                # the joined schema
                renamed = ProjectionExec(
                    [(pe.Col(g), f"__dk{i}_{g}") for g in group_names]
                    + [(pe.Col(s.output_name), s.output_name)],
                    cnt,
                )
                combined = HashJoinExec(
                    combined, renamed,
                    group_names, [f"__dk{i}_{g}" for g in group_names],
                    "inner", expansion_factor=1.0,
                    out_capacity=combined.output_capacity(),
                )
            order = [(pe.Col(g), g) for g in group_names] + [
                (pe.Col(a.name), a.name) for a in node.aggs
            ]
            return ProjectionExec(order, combined)

        if distinct_aggs:
            # COUNT(DISTINCT x): dedup (groups + x), then count per group.
            inner_groups = group_names + [s.input_name for s in specs]
            inner_ndv = self._exprs_ndv(
                node.child,
                [e for e, _ in node.groups] + [a.arg for a in node.aggs],
                loose=True,
            )
            slots = self._agg_slots(proj.output_capacity(), inner_ndv,
                                    child=proj)
            dedup = HashAggregateExec("single", inner_groups, [], proj, slots)
            if inner_ndv:
                # estimate_rows(dedup) would otherwise fall back to
                # sqrt(n) and undersize the outer aggregate's by_est cap
                dedup.est_rows = float(inner_ndv)
            outer_specs = [
                AggSpec("count", s.input_name, s.output_name) for s in specs
            ]
            groups_ndv = self._exprs_ndv(node.child,
                                         [e for e, _ in node.groups],
                                         loose=True)
            slots2 = self._agg_slots(dedup.output_capacity(), groups_ndv,
                                     child=dedup)
            out = HashAggregateExec(
                "single", group_names, outer_specs, dedup, slots2
            )
            if groups_ndv:
                out.est_rows = float(groups_ndv)
            return out

        groups_ndv = self._exprs_ndv(node.child, [e for e, _ in node.groups],
                                     loose=True)
        slots = self._agg_slots(proj.output_capacity(), groups_ndv,
                                child=proj)
        out = HashAggregateExec("single", group_names, specs, proj, slots)
        if groups_ndv:
            # catalog NDV as the group-count estimate (replaces the cost
            # model's sqrt(n) guess; consumed by statistics.estimate_rows)
            out.est_rows = float(groups_ndv)
        return out

    def _predicate_selectivity(self, pred, child: lg.LogicalPlan,
                               ) -> Optional[float]:
        """Selectivity estimate from catalog NDV (the statistics the cost
        model previously guessed as a blanket 1/3): equality on a base
        column keeps ~1/NDV rows, IN keeps k/NDV, AND multiplies, OR adds.
        None = no NDV-backed estimate (range predicates, derived exprs)."""
        if isinstance(pred, pe.BooleanOp):
            l = self._predicate_selectivity(pred.left, child)
            r = self._predicate_selectivity(pred.right, child)
            if l is None and r is None:
                return None
            l = 1.0 / 3.0 if l is None else l
            r = 1.0 / 3.0 if r is None else r
            return max(l * r, 1e-6) if pred.op == "and" else min(l + r, 1.0)
        if isinstance(pred, pe.Not):
            s = self._predicate_selectivity(pred.child, child)
            return None if s is None else max(1.0 - s, 1e-6)
        if isinstance(pred, pe.BinaryOp) and pred.op == "==":
            col, other = pred.left, pred.right
            if not isinstance(col, pe.Col):
                col, other = other, col
            if isinstance(col, pe.Col) and isinstance(other, pe.Literal):
                ndv = self._exprs_ndv(child, [col])
                if ndv:
                    return 1.0 / ndv
        if isinstance(pred, pe.InList) and isinstance(pred.child, pe.Col):
            ndv = self._exprs_ndv(child, [pred.child])
            if ndv:
                s = min(len(pred.values) / ndv, 1.0)
                return max(1.0 - s, 1e-6) if pred.negated else s
        return None

    def _agg_slots(self, cap: int, ndv: Optional[int] = None,
                   child=None) -> int:
        """Hash-table slots for a group-by: capacity-bounded, NDV-driven,
        row-estimate-capped.

        The reference sizes aggregation hash tables dynamically as groups
        arrive; with static shapes the table must be pre-sized, and sizing by
        input *capacity* makes a 6-group GROUP BY run a 2M-slot claim
        loop. When the distinct-group estimate is known, size by it instead:
        2x the planner's slot factor over the estimate keeps the probe chain
        short, and the session's overflow-retry loop (collect_table) widens
        by 4x if the estimate was low — the same optimistic-plan /
        revise-on-overflow posture as join capacities.

        ``child`` (the agg's physical input) adds a third bound: groups
        can never exceed input ROWS, and after selective filters/joins the
        cardinality estimate is far below both the padded capacity and the
        multi-key NDV product (q3's (orderkey, orderdate, shippriority)
        NDV-product saturates while the filtered join feeds ~29k rows).
        Row estimates are coarser than sampled NDV, so this bound gets 4x
        headroom instead of 2x; an underestimate costs one overflow-retry.
        """
        by_cap = min(
            round_up_pow2(max(int(cap * self.config.agg_slot_factor), 16)),
            self.config.max_slots,
        )
        best = by_cap
        if ndv:
            by_ndv = round_up_pow2(
                max(int(ndv * self.config.agg_slot_factor * 2), 16)
            )
            best = min(best, by_ndv)
        if child is not None:
            from datafusion_distributed_tpu_torch.planner.statistics import (
                estimate_rows,
            )

            est = estimate_rows(child)
            by_est = round_up_pow2(
                max(int(est * self.config.agg_slot_factor * 4), 16)
            )
            best = min(best, by_est)
        return best

    def _exprs_ndv(self, child: lg.LogicalPlan,
                   exprs: Sequence[pe.PhysicalExpr],
                   loose: bool = False) -> Optional[int]:
        """Distinct-count estimate for a tuple of expressions, or None.

        Two modes:
        - strict (default): direct base-table column references (via the
          catalog's sampled NDV), followed through projection ALIASES; any
          derived expression makes the tuple unknown. Safe for selectivity
          (1/NDV) estimates.
        - loose=True: additionally derives UPPER bounds for common derived
          shapes — calendar parts (EXTRACT/DATE_TRUNC caps), unary
          value-preserving ops, binary arithmetic (ndv product),
          boolean-valued ops (3), CASE/COALESCE (branch sums). Upper
          bounds are only safe for capacity SIZING (an overestimate just
          pads; q9's (nation, o_year) aggregate sized 2M slots for a true
          NDV of ~175 without them) — NOT for 1/NDV selectivity, where a
          loose bound inverts into an underestimate.

        Products over multiple keys ignore correlation, which biases the
        multi-key estimate *upward* (joins can't mint new key values).
        Per-column estimates, however, come from a strided SAMPLE: below
        the extrapolation threshold they can undercount true NDV, so the
        catalog pads non-extrapolated sampled counts (see
        `Catalog.column_ndv`) — treat the result as a best-effort sizing
        hint backed by the overflow-retry loop, not a hard upper bound."""
        ndv_fn = getattr(self.catalog, "column_ndv", None)
        if ndv_fn is None:
            return None
        aliases: dict[str, str] = {}
        proj_map: dict = {}
        _poisoned = object()
        stack = [child]
        while stack:
            n = stack.pop()
            if isinstance(n, lg.LScan):
                # the same alias naming DIFFERENT base tables in nested
                # scopes (correlated subquery reusing an outer alias) makes
                # the lookup ambiguous: poison it rather than let the
                # last-visited scan win and size against the wrong table
                if aliases.get(n.alias, n.table) != n.table:
                    aliases[n.alias] = None
                else:
                    aliases[n.alias] = n.table
            elif isinstance(n, lg.LProject):
                # projection aliases let bounds see THROUGH derived columns
                # (q9 groups by a subquery's `o_year` = EXTRACT alias);
                # a name bound to different exprs in different branches is
                # ambiguous -> poisoned
                for e, name in n.exprs:
                    if name in proj_map and proj_map[name] is not e:
                        proj_map[name] = _poisoned
                    else:
                        proj_map.setdefault(name, e)
            stack.extend(n.children())
        # calendar-part cardinality caps (EXTRACT/DATE_TRUNC derive columns
        # with small, known ranges — without these, a GROUP BY on
        # EXTRACT(YEAR ...) falls back to row-count sizing: q9's (nation,
        # o_year) aggregate was handed 2M slots for a true NDV of ~175)
        part_caps = {
            "year": 200, "month": 12, "moy": 12, "quarter": 4, "qoy": 4,
            "day": 31, "dom": 31, "dow": 7, "doy": 366, "week": 53,
            "hour": 24, "minute": 60, "second": 60,
        }
        trunc_caps = {"year": 200, "quarter": 800, "month": 2400,
                      "week": 11000, "day": 75000}

        def col_ndv(e: pe.Col) -> Optional[int]:
            if "." not in e.name:
                return None
            alias, col = e.name.split(".", 1)
            table = aliases.get(alias)
            if table is None:
                return None
            ndv = ndv_fn(table, col)
            return int(ndv) if ndv else None

        def bound(e, depth: int = 0) -> Optional[int]:
            """Distinct count (strict) or upper bound (loose), or None."""
            if depth > 8:  # projection-chain guard
                return None
            if isinstance(e, pe.Col):
                direct = col_ndv(e)
                if direct is not None:
                    return direct
                sub = proj_map.get(e.name)
                if sub is not None and sub is not _poisoned and not (
                    isinstance(sub, pe.Col) and sub.name == e.name
                ):
                    return bound(sub, depth + 1)
                return None
            if isinstance(e, pe.Literal):
                return 1
            if not loose:
                return None
            if isinstance(e, (pe.BooleanOp, pe.Not, pe.IsNull, pe.Like,
                              pe.InList)):
                return 3  # true/false/NULL
            if isinstance(e, pe.BinaryOp) and e.op in pe._CMP_OPS:
                return 3
            if isinstance(e, pe.Extract):
                cap = part_caps.get(e.part.lower())
                inner = bound(e.child, depth + 1)
                if cap is None:
                    return inner
                return min(cap, inner) if inner else cap
            if isinstance(e, pe.DateTrunc):
                cap = trunc_caps.get(e.unit.lower())
                inner = bound(e.child, depth + 1)
                if cap is None:
                    return inner
                return min(cap, inner) if inner else cap
            if isinstance(e, (pe.Substring, pe.StringCase, pe.Cast,
                              pe.Abs, pe.Round, pe.StrLength)):
                return bound(e.children()[0], depth + 1)
            if isinstance(e, pe.BinaryOp):
                l, r = bound(e.left, depth + 1), bound(e.right, depth + 1)
                if l and r:
                    return l * r  # upper bound; correlation only shrinks it
                return None
            if isinstance(e, pe.Case):
                # value space = union of branch values (+ otherwise/NULL)
                total = 0
                for _, v in e.branches:
                    b = bound(v, depth + 1)
                    if b is None:
                        return None
                    total += b
                if e.otherwise is not None:
                    b = bound(e.otherwise, depth + 1)
                    if b is None:
                        return None
                    total += b
                return total + 1
            if isinstance(e, pe.Coalesce):
                total = 0
                for c in e.children():
                    b = bound(c, depth + 1)
                    if b is None:
                        return None
                    total += b
                return total
            return None

        est = 1
        for e in exprs:
            b = bound(e)
            if not b:
                return None
            est *= int(b)
        return est

    def _distinct(self, child: ExecutionPlan) -> ExecutionPlan:
        names = child.schema().names
        return HashAggregateExec(
            "single", names, [], child,
            self._agg_slots(child.output_capacity(), child=child),
        )

    # -- join -----------------------------------------------------------------------
    def _plan_join(self, node: lg.LJoin, used: set) -> ExecutionPlan:
        left = self._plan(node.left, used)
        right = self._plan(node.right, used)
        if node.how == "cross":
            return CrossJoinExec(left, right)

        def materialize_keys(plan, keys, side):
            names = []
            extra = []
            schema = plan.schema()
            for k in keys:
                self._resolve_subqueries(k)
                if isinstance(k, pe.Col):
                    names.append(k.name)
                else:
                    nm = f"__jk{side}{next(_TMP)}"
                    extra.append((k, nm))
                    names.append(nm)
            if extra:
                passthrough = [(pe.Col(f.name), f.name) for f in schema.fields]
                plan = ProjectionExec(passthrough + extra, plan)
            return plan, names

        left, lnames = materialize_keys(left, node.left_keys, "l")
        right, rnames = materialize_keys(right, node.right_keys, "r")
        if node.residual is not None:
            self._resolve_subqueries(node.residual)
        # Build-side hash table: CSR over DISTINCT keys (ops/join.py), so
        # slots size by build-key NDV, same rationale (and same
        # overflow-retry widening, via join_expansion_factor) as _agg_slots.
        # HashJoinExec builds over its RIGHT child (probe=left, build=right).
        build_ndv = self._exprs_ndv(node.right, node.right_keys)
        num_slots = None
        if build_ndv:
            num_slots = min(
                round_up_pow2(2 * max(right.output_capacity(), 8)),
                round_up_pow2(max(
                    int(build_ndv * 2
                        * max(1.0, self.config.join_expansion_factor)),
                    16,
                )),
                1 << 21,
            )
        join = HashJoinExec(
            left,
            right,
            lnames,
            rnames,
            node.how,
            residual=node.residual,
            mark_name=node.mark_name or "__mark",
            expansion_factor=self.config.join_expansion_factor
            * max(1.0, getattr(node, "fanout_hint", 1.0)),
            null_aware=node.null_aware,
            num_slots=num_slots,
        )
        # strip materialized key columns from inner/left outputs
        if node.how in ("inner", "left"):
            want = [f.name for f in node.schema().fields]
            have = set(join.schema().names)
            keep = [n for n in want if n in have]
            if set(keep) != set(join.schema().names):
                return ProjectionExec([(pe.Col(n), n) for n in keep], join)
        return join

    # -- sort ------------------------------------------------------------------------
    def _plan_sort(self, node: lg.LSort, used: set) -> ExecutionPlan:
        child = self._plan(node.child, used)
        schema = child.schema()
        keys = []
        extra = []
        for e, asc, nulls_first in node.keys:
            self._resolve_subqueries(e)
            if isinstance(e, pe.Col):
                name = e.name
            else:
                name = f"__sk{next(_TMP)}"
                extra.append((e, name))
            if nulls_first is None:
                nulls_first = not asc  # SQL default: NULLS LAST for ASC
            keys.append(SortKey(name, asc, nulls_first))
        plan: ExecutionPlan = child
        if extra:
            passthrough = [(pe.Col(f.name), f.name) for f in schema.fields]
            plan = ProjectionExec(passthrough + extra, plan)
        plan = SortExec(keys, plan, fetch=node.fetch)
        if extra:
            plan = ProjectionExec(
                [(pe.Col(f.name), f.name) for f in schema.fields], plan
            )
        return plan

    # -- set ops -----------------------------------------------------------------------
    def _plan_setop(self, node: lg.LSetOp, used: set) -> ExecutionPlan:
        left = self._plan(node.left, used)
        right = self._plan(node.right, used)
        if node.op == "union":
            return UnionExec([left, right])
        # INTERSECT/EXCEPT are DISTINCT semi/anti joins on all columns
        left_d = self._distinct(left)
        how = "semi" if node.op == "intersect" else "anti"
        return HashJoinExec(
            left_d, right, list(left_d.schema().names),
            list(right.schema().names), how,
            expansion_factor=self.config.join_expansion_factor,
        )

    # -- scalar subqueries ---------------------------------------------------------------
    def _resolve_subqueries(self, expr: pe.PhysicalExpr) -> None:
        # no memoization guard: a replan after an overflow must re-plan the
        # subquery with the widened config too
        if isinstance(expr, lg.ScalarSubqueryExpr):
            sub_planner = PhysicalPlanner(
                self.catalog, self.config, self.subquery_executor
            )
            expr.physical = sub_planner.plan(expr.logical)
            # Execute NOW, at planning time: the value becomes a constant of
            # the outer plan.
            value, dtype = _exec_scalar(expr.physical, self.subquery_executor)
            expr.evaluate = _make_scalar_eval(value, dtype)  # type: ignore[method-assign]
            expr.resolved = (value, dtype)  # lets the wire codec ship it
        for c in expr.children():
            self._resolve_subqueries(c)


def _collect_used_columns(plan: lg.LogicalPlan) -> set:
    """Every flat column name referenced by any expression in the tree (plus
    subquery trees). Scans prune to this set — the projection-pushdown
    analogue of DataFusion's physical optimizer."""
    used: set = set()

    def walk_expr(e: pe.PhysicalExpr):
        if isinstance(e, pe.Col):
            used.add(e.name)
        if isinstance(e, lg.ScalarSubqueryExpr):
            used.update(_collect_used_columns(e.logical))
        for c in e.children():
            walk_expr(c)

    def walk(n: lg.LogicalPlan):
        if isinstance(n, lg.LFilter):
            walk_expr(n.predicate)
        elif isinstance(n, lg.LProject):
            for e, _ in n.exprs:
                walk_expr(e)
        elif isinstance(n, lg.LAggregate):
            for e, _ in n.groups:
                walk_expr(e)
            for a in n.aggs:
                if a.arg is not None:
                    walk_expr(a.arg)
        elif isinstance(n, lg.LJoin):
            for e in n.left_keys + n.right_keys:
                walk_expr(e)
            if n.residual is not None:
                walk_expr(n.residual)
        elif isinstance(n, lg.LSort):
            for e, _, _ in n.keys:
                walk_expr(e)
        elif isinstance(n, lg.LWindow):
            for w in n.exprs:
                if w.arg is not None:
                    walk_expr(w.arg)
                for p in w.partition_by:
                    walk_expr(p)
                for oe, _, _ in w.order_by:
                    walk_expr(oe)
        elif isinstance(n, (lg.LSetOp, lg.LDistinct)):
            for f in n.schema().fields:
                used.add(f.name)
        for c in n.children():
            walk(c)

    for f in plan.schema().fields:
        used.add(f.name)
    walk(plan)
    return used


def _exec_scalar(physical: ExecutionPlan, executor=None):
    """Run a scalar subquery plan to completion; -> (python scalar|None, dtype)."""
    from datafusion_distributed_tpu_torch.plan.physical import execute_plan

    result = executor(physical) if executor is not None else execute_plan(physical)
    col = result.columns[0]
    n = int(result.num_rows)
    if n > 1:
        raise RuntimeError(
            f"scalar subquery returned {n} rows (expected at most one)"
        )
    if n == 0:
        return None, col.dtype
    if col.validity is not None and not bool(col.validity[0]):
        return None, col.dtype
    return col.data[0].item(), col.dtype


def _make_scalar_eval(value, dtype):
    import torch

    def evaluate(table):
        cap = table.capacity
        if value is None:
            return pe.ExprValue(
                torch.zeros(cap, dtype=dtype.torch_dtype, device=table.device),
                torch.zeros(cap, dtype=torch.bool, device=table.device),
                dtype,
            )
        data = torch.full((cap,), value, dtype=dtype.torch_dtype,
                          device=table.device)
        return pe.ExprValue(data, None, dtype)

    return evaluate
