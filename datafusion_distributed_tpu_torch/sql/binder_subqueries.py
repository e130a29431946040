"""Subquery half of the binder (mixin; split out of logical.py).

Decorrelation machinery: uncorrelated scalar subqueries become lazily
executed ScalarSubqueryExpr placeholders; correlated scalar-aggregate
subqueries decorrelate into GROUP BY + LEFT JOIN (TPC-H q2/q17/q20 shape);
[NOT] EXISTS / [NOT] IN become semi/anti/mark joins with optional residual
predicates (q4/q21/q22); disjunctive subquery predicates lower to mark
joins. The reference gets all of this from DataFusion upstream — this is
original machinery with no reference counterpart.
"""

from __future__ import annotations

import itertools

from datafusion_distributed_tpu_torch.plan import expressions as pe
from datafusion_distributed_tpu_torch.schema import Field, Schema
from datafusion_distributed_tpu_torch.sql import parser as ast
from datafusion_distributed_tpu_torch.sql.ast_utils import (
    _ast_children,
    _ast_substitute,
    _collect_col_names,
    _contains_subquery,
    _has_aggregates,
    _hoist_common_or,
    _join_conjuncts,
    _project_through,
    _split_conjuncts,
)
from datafusion_distributed_tpu_torch.sql.lplan import (
    LFilter,
    LJoin,
    LProject,
    LogicalPlan,
)
from datafusion_distributed_tpu_torch.sql.scope import BindError, OuterRef, Scope

# mark-join column namer: process-wide so two filters in one query can't
# collide, resettable (like planner._TMP) so plan snapshots are reproducible
_MARK_SEQ = itertools.count()


# ---------------------------------------------------------------------------
# Scalar subquery expression (executed lazily by the physical layer)
# ---------------------------------------------------------------------------


class ScalarSubqueryExpr(pe.PhysicalExpr):
    """Placeholder for an uncorrelated scalar subquery; the physical planner
    replaces it with a literal after executing the subplan (the reference
    disables DataFusion's uncorrelated-subquery pushdown and relies on plain
    planning, `session_state_builder_ext.rs:17-27` — here we evaluate it as a
    prepared constant instead)."""

    def __init__(self, logical: LogicalPlan):
        self.logical = logical
        self.physical = None  # filled by the physical planner

    def children(self):
        return []

    def evaluate(self, table):
        raise RuntimeError(
            "ScalarSubqueryExpr must be resolved by the physical planner"
        )

    def output_field(self, schema):
        if self.logical is None:  # a constant decoded off the wire
            return Field("__scalar_subquery", self.resolved[1], True)
        f = self.logical.schema().fields[0]
        return Field("__scalar_subquery", f.dtype, True)

    @classmethod
    def resolved_constant(cls, value, dtype) -> "ScalarSubqueryExpr":
        """A subquery already executed, as the coordinator's plan codec
        ships it: its value and dtype, fingerprinted like the original
        (plan/fingerprint.py "subqlit"), so a worker's decoded plan keeps
        the coordinator's fingerprint."""
        from datafusion_distributed_tpu_torch.sql.planner import (
            _make_scalar_eval,
        )

        e = cls(None)
        e.evaluate = _make_scalar_eval(value, dtype)
        e.resolved = (value, dtype)
        return e

    def display(self):
        return "(scalar subquery)"



class SubqueryDecorrelationMixin:
    """Binder methods for subquery predicates and decorrelation."""

    # -- subquery predicates ----------------------------------------------------
    def _apply_subquery_pred(self, c, plan, scope, outer_refs) -> LogicalPlan:
        if isinstance(c, ast.Exists):
            return self._bind_exists(c.query, c.negated, plan, scope)
        if isinstance(c, ast.Unary) and c.op == "not" and isinstance(
            c.child, ast.Exists
        ):
            return self._bind_exists(c.child.query, not c.child.negated, plan, scope)
        if isinstance(c, ast.InSubquery):
            return self._bind_in_subquery(c, plan, scope, outer_refs)
        if isinstance(c, ast.Between) and not c.negated:
            # BETWEEN with subquery bounds (TPC-DS q54): split into the two
            # comparisons and route each through the right binder
            for shard in (
                ast.Binary(">=", c.expr, c.low),
                ast.Binary("<=", c.expr, c.high),
            ):
                if _contains_subquery(shard):
                    plan = self._apply_subquery_pred(
                        shard, plan, scope, outer_refs
                    )
                else:
                    plan = LFilter(
                        self._bind_expr(shard, scope, outer_refs), plan
                    )
            return plan
        if isinstance(c, ast.Binary) and c.op == "and":
            for side in (c.left, c.right):
                if _contains_subquery(side):
                    plan = self._apply_subquery_pred(
                        side, plan, scope, outer_refs
                    )
                else:
                    plan = LFilter(
                        self._bind_expr(side, scope, outer_refs), plan
                    )
            return plan
        if isinstance(c, ast.Binary) and c.op == "or":
            # disjunction containing EXISTS/IN-subquery (TPC-DS q35/q45):
            # each subquery becomes a MARK join; the disjunction then
            # evaluates over the mark columns as a plain filter
            return self._apply_disjunctive_subquery(c, plan, scope, outer_refs)
        # scalar subquery inside a comparison
        return self._bind_scalar_pred(c, plan, scope, outer_refs)

    def _apply_disjunctive_subquery(self, c, plan, scope, outer_refs):
        """Rewrite a boolean expression whose leaves include EXISTS /
        IN-subquery into mark joins + a boolean filter over the mark columns
        (the reference gets this from DataFusion's subquery decorrelation,
        which lowers to the same mark-join shape)."""
        plan_box = [plan]

        def walk(node):
            if isinstance(node, ast.Binary) and node.op in ("and", "or"):
                l = walk(node.left)
                r = walk(node.right)
                return pe.BooleanOp(node.op, l, r)
            if isinstance(node, ast.Unary) and node.op == "not":
                return pe.Not(walk(node.child))
            if isinstance(node, ast.Exists):
                mark = self._mark_join_exists(node, plan_box, scope)
                return pe.Not(mark) if node.negated else mark
            if isinstance(node, ast.InSubquery):
                mark = self._mark_join_in(node, plan_box, scope, outer_refs)
                return pe.Not(mark) if node.negated else mark
            return self._bind_expr(node, scope, outer_refs)

        def _mark_name():
            # process-wide monotonic counter: unique across every mark join
            # in the query AND deterministic (resettable) for plan snapshots
            return f"__mark_{next(_MARK_SEQ)}"

        self.__mark_name = _mark_name  # shared with helpers below
        pred = walk(c)
        return LFilter(pred, plan_box[0])

    def _mark_join_exists(self, node: ast.Exists, plan_box, scope):
        sub_binder = type(self)(self.catalog, self.ctes)
        sub_refs: list = []
        sub_plan, corr_pairs, residual = sub_binder._bind_correlated(
            node.query, scope, sub_refs
        )
        if not corr_pairs:
            raise BindError("uncorrelated EXISTS not supported yet")
        name = self.__mark_name()
        plan_box[0] = LJoin(
            plan_box[0], sub_plan, "mark",
            [pe.Col(outer) for outer, _ in corr_pairs],
            [inner for _, inner in corr_pairs],
            residual=residual, mark_name=name,
        )
        return pe.Col(name)

    def _mark_join_in(self, node: ast.InSubquery, plan_box, scope, outer_refs):
        expr = self._bind_expr(node.expr, scope, outer_refs)
        sub_binder = type(self)(self.catalog, self.ctes)
        sub_refs: list = []
        sub_plan, corr_pairs, residual = sub_binder._bind_correlated(
            node.query, scope, sub_refs
        )
        out_cols = sub_plan.schema()
        if len(out_cols) - len(corr_pairs) != 1 and len(out_cols) != 1:
            raise BindError("IN subquery must produce one column")
        name = self.__mark_name()
        plan_box[0] = LJoin(
            plan_box[0], sub_plan, "mark",
            [expr] + [pe.Col(outer) for outer, _ in corr_pairs],
            [pe.Col(out_cols.fields[0].name)] + [
                inner for _, inner in corr_pairs
            ],
            residual=residual, mark_name=name,
        )
        return pe.Col(name)

    def _bind_exists(self, subq: ast.Query, negated: bool, plan, scope):
        sub_binder = type(self)(self.catalog, self.ctes)
        sub_refs: list[OuterRef] = []
        sub_plan, corr_pairs, residual = sub_binder._bind_correlated(
            subq, scope, sub_refs
        )
        if not corr_pairs:
            raise BindError("uncorrelated EXISTS not supported yet")
        lkeys = [pe.Col(outer) for outer, _ in corr_pairs]
        rkeys = [inner for _, inner in corr_pairs]
        how = "anti" if negated else "semi"
        return LJoin(plan, sub_plan, how, lkeys, rkeys, residual=residual)

    def _bind_in_subquery(self, c: ast.InSubquery, plan, scope, outer_refs):
        expr = self._bind_expr(c.expr, scope, outer_refs)
        sub_binder = type(self)(self.catalog, self.ctes)
        sub_refs: list[OuterRef] = []
        sub_plan, corr_pairs, residual = sub_binder._bind_correlated(
            c.query, scope, sub_refs
        )
        out_cols = sub_plan.schema()
        if len(out_cols) - len(corr_pairs) != 1 and len(out_cols) != 1:
            raise BindError("IN subquery must produce one column")
        value_col = pe.Col(out_cols.fields[0].name)
        lkeys = [expr] + [pe.Col(outer) for outer, _ in corr_pairs]
        rkeys = [value_col] + [inner for _, inner in corr_pairs]
        how = "anti" if c.negated else "semi"
        return LJoin(plan, sub_plan, how, lkeys, rkeys, residual=residual,
                     null_aware=c.negated)

    def _bind_scalar_pred(self, c, plan, scope, outer_refs):
        """Comparison against a scalar subquery (correlated or not)."""
        if not (isinstance(c, ast.Binary) and c.op in ("==", "!=", "<", "<=",
                                                       ">", ">=")):
            raise BindError(
                f"unsupported subquery predicate shape: {type(c).__name__}"
            )
        # The subquery may sit anywhere inside the comparison (TPC-DS q6:
        # `price > 1.2 * (select avg(...))`): locate it, bind it, splice the
        # bound scalar back in, then bind the whole comparison normally.
        found: list = []

        def hunt(node):
            if isinstance(node, ast.ScalarSubquery):
                found.append(node)
                return node  # do not descend further
            return None

        _ast_substitute(c, hunt)
        if len(found) != 1:
            raise BindError("expected scalar subquery in comparison")
        sub_ast = found[0]

        sub_binder = type(self)(self.catalog, self.ctes)
        sub_refs: list[OuterRef] = []
        sub_plan, corr_pairs, residual = sub_binder._bind_correlated(
            sub_ast.query, scope, sub_refs
        )
        if residual is not None:
            raise BindError("non-equi correlation in scalar subquery")

        if not corr_pairs:
            # uncorrelated: evaluate eagerly at execution time
            spliced = _ast_substitute(
                c, lambda n: ast.PreBound(ScalarSubqueryExpr(sub_plan))
                if n is sub_ast else None,
            )
            return LFilter(self._bind_expr(spliced, scope, outer_refs), plan)

        # correlated scalar aggregate: sub_plan is Aggregate(groups=corr keys)
        scalar_col = pe.Col(sub_plan.schema().fields[-1].name)
        lkeys = [pe.Col(outer) for outer, _ in corr_pairs]
        rkeys = [inner for _, inner in corr_pairs]
        joined = LJoin(plan, sub_plan, "left", lkeys, rkeys)
        spliced = _ast_substitute(
            c, lambda n: ast.PreBound(scalar_col) if n is sub_ast else None,
        )
        filtered = LFilter(
            self._bind_expr(spliced, scope, outer_refs), joined
        )
        # project away subquery columns
        keep = [
            (pe.Col(f.name), f.name) for f in plan.schema().fields
        ]
        return LProject(keep, filtered)

    def _bind_correlated(self, subq: ast.Query, outer_scope, sub_refs):
        """Bind a subquery that may reference the outer scope.

        Returns (plan, corr_pairs, residual) where corr_pairs are
        (outer_flat_name, inner key PhysicalExpr) equi correlations hoisted
        out of the subquery's WHERE, and residual is a bound predicate over
        the [outer columns joined with subquery output] schema for non-equi
        correlated conjuncts (EXISTS with <> as in TPC-H q21).
        """
        q = subq
        conjuncts = _split_conjuncts(q.where) if q.where is not None else []
        # surface correlations hidden inside OR branches (q41 shape)
        conjuncts = [x for c in conjuncts for x in _hoist_common_or(c)]
        corr: list[tuple[str, ast.Ident]] = []  # (outer flat, inner ast)
        residual_asts: list = []
        local: list = []
        probe_scope = self._subquery_scope(q, outer_scope)
        for c in conjuncts:
            side = self._correlation_side(c, probe_scope)
            if side == "local":
                local.append(c)
            elif side == "equi":
                outer_ast, inner_ast = self._split_correlation(c, probe_scope)
                corr.append((outer_ast, inner_ast))
            else:  # residual correlated
                residual_asts.append(c)

        q2 = ast.Query(
            select_items=q.select_items,
            from_refs=q.from_refs,
            where=_join_conjuncts(local),
            group_by=q.group_by,
            having=q.having,
            order_by=q.order_by,
            limit=q.limit,
            offset=q.offset,
            distinct=q.distinct,
            ctes=q.ctes,
        )

        if corr and _has_aggregates(q2):
            # correlated scalar aggregate -> group by correlation keys
            inner_group_asts = [inner for _, inner in corr]
            q2 = ast.Query(
                select_items=list(q2.select_items)
                + [ast.SelectItem(a, f"__corr{i}") for i, a in
                   enumerate(inner_group_asts)],
                from_refs=q2.from_refs,
                where=q2.where,
                group_by=list(q2.group_by) + inner_group_asts,
                having=q2.having,
                order_by=[],
                limit=None,
                offset=None,
                distinct=False,
                ctes=q2.ctes,
            )
            plan = self._bind_query(q2, None)
            fields = plan.schema().fields
            ncorr = len(corr)
            pairs = []
            for (outer_flat, _), f in zip(corr, fields[-ncorr:]):
                pairs.append((outer_flat, pe.Col(f.name)))
            # keep scalar as last col before corr keys: re-project so schema =
            # [corr keys..., scalar]
            scalar_field = fields[-ncorr - 1]
            proj = [(pe.Col(f.name), f.name) for f in fields[-ncorr:]]
            proj.append((pe.Col(scalar_field.name), scalar_field.name))
            plan = LProject(proj, plan)
            return plan, pairs, None

        plan = self._bind_query(q2, None)
        pairs = []
        for outer_flat, inner_ast in corr:
            inner_scope = self._subquery_scope(q2, None)
            inner_bound = type(self)(self.catalog, self.ctes)._bind_expr(
                inner_ast, inner_scope, None
            )
            # the subquery's output schema must expose the key column; ensure
            # it by projecting the join keys alongside existing outputs
            pairs.append((outer_flat, inner_bound))
        residual = None
        if residual_asts:
            # bind residual against outer+inner: inner entries SHADOW outer
            # ones (an unqualified name over two `item` relations must pick
            # the subquery's own, q41), while outer names stay reachable —
            # qualified or via the parent scope
            combined = Scope(
                self._subquery_scope(q2, None).entries, parent=outer_scope
            )
            shadow_refs: list = []
            bound = [
                self._bind_expr(a, combined, shadow_refs)
                for a in residual_asts
            ]
            residual = bound[0]
            for b in bound[1:]:
                residual = pe.BooleanOp("and", residual, b)
        if pairs or residual is not None:
            # Expose referenced inner columns through the subquery's output
            # projection. Outer-side names in the residual stay out — they
            # resolve against the probe side of the join at execution.
            inner_aliases = {
                alias for alias, _ in self._subquery_scope(q2, None).entries
            }
            needed = _collect_col_names(
                [p for _, p in pairs] + ([residual] if residual is not None else [])
            )
            existing = set(f.name for f in plan.schema().fields)
            missing = [
                n for n in needed
                if n not in existing and n.split(".")[0] in inner_aliases
            ]
            if missing:
                exprs = [(pe.Col(f.name), f.name) for f in plan.schema().fields]
                exprs += [(pe.Col(n), n) for n in missing]
                plan = _project_through(plan, exprs)
        return plan, pairs, residual

    def _subquery_scope(self, q: ast.Query, outer_scope) -> Scope:
        entries = []
        for base, joins in q.from_refs:
            for ref in [base] + [j.right for j in joins]:
                if isinstance(ref, ast.TableRef):
                    alias = ref.alias or ref.name
                    if ref.name in self.ctes:
                        sub = self.ctes[ref.name]
                        names = [f.name.split(".")[-1] for f in sub.schema().fields]
                        entries.append(
                            (alias, Schema([Field(n, f.dtype, f.nullable)
                                            for n, f in zip(names, sub.schema().fields)]))
                        )
                    else:
                        entries.append((alias, self.catalog.table_schema(ref.name)))
                else:
                    sub_binder = type(self)(self.catalog, self.ctes)
                    sub = sub_binder._bind_query(ref.query, None)
                    names = ref.column_aliases or [
                        f.name.split(".")[-1] for f in sub.schema().fields
                    ]
                    entries.append(
                        (ref.alias, Schema([Field(n, f.dtype, f.nullable)
                                            for n, f in zip(names, sub.schema().fields)]))
                    )
        return Scope(entries, parent=outer_scope)

    def _combined_scope(self, q: ast.Query, outer_scope) -> Scope:
        inner = self._subquery_scope(q, None)
        entries = list(inner.entries) + (
            list(outer_scope.entries) if outer_scope else []
        )
        return Scope(entries)

    def _correlation_side(self, c, probe_scope: Scope) -> str:
        """'local' (no outer refs) | 'equi' (outer = inner) | 'residual'."""
        refs = self._outer_ref_names(c, probe_scope)
        if not refs:
            return "local"
        if isinstance(c, ast.Binary) and c.op == "==":
            lrefs = self._outer_ref_names(c.left, probe_scope)
            rrefs = self._outer_ref_names(c.right, probe_scope)
            if (
                isinstance(c.left, ast.Ident)
                and lrefs
                and not rrefs
                or isinstance(c.right, ast.Ident)
                and rrefs
                and not lrefs
            ):
                return "equi"
        return "residual"

    def _split_correlation(self, c: ast.Binary, probe_scope: Scope):
        lrefs = self._outer_ref_names(c.left, probe_scope)
        if lrefs and isinstance(c.left, ast.Ident):
            outer_ast, inner_ast = c.left, c.right
        else:
            outer_ast, inner_ast = c.right, c.left
        flat, _, _ = probe_scope.parent.resolve(outer_ast) if probe_scope.parent else (
            None, None, None
        )
        if flat is None:
            raise BindError("failed to resolve correlation")
        return flat, inner_ast

    def _outer_ref_names(self, node, probe_scope: Scope) -> list[str]:
        out = []

        def walk(n):
            if isinstance(n, ast.Ident):
                try:
                    _, _, depth = probe_scope.resolve(n)
                    if depth > 0:
                        out.append(n.key())
                except BindError:
                    pass
                return
            for ch in _ast_children(n):
                walk(ch)

        walk(node)
        return out

    def _aliases_of(self, node, scope: Scope) -> set:
        out: set = set()

        def walk(n):
            if isinstance(n, ast.Ident):
                try:
                    flat, _, depth = scope.resolve(n)
                    if depth == 0:
                        out.add(flat.split(".")[0])
                except BindError:
                    pass
                return
            for ch in _ast_children(n):
                walk(ch)

        walk(node)
        return out
