"""Physical join + union operators (port of the reference `plan/joins.py`:
HashJoinExec, MultiwayHashJoinExec, CrossJoinExec, UnionExec).

The join kernel is ops/join.py's build/probe/expand; this module is the
plan-tree layer: residual predicates, mark/semi/anti modes, null-aware NOT IN,
dictionary unification of string keys, and capacity policy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

from datafusion_distributed_tpu_torch.ops.join import (
    build_join_table,
    hash_join,
)
from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Dictionary,
    Table,
    apply_lut,
    concat_tables,
    drop_index,
    round_up_pow2,
)
from datafusion_distributed_tpu_torch.plan.expressions import PhysicalExpr
from datafusion_distributed_tpu_torch.plan.physical import ExecContext, ExecutionPlan
from datafusion_distributed_tpu_torch.schema import DataType, Field, Schema

_PROBE_IDX = "__probe_idx"

_MAX_DERIVED_JOIN_CAPACITY = 1 << 25


class HashJoinExec(ExecutionPlan):
    """Hash join. probe = left child (preserved side), build = right child.

    join_type: inner | left | semi | anti | mark. Keys are column names (the
    planner materializes key expressions into columns below the join).
    `residual` is an extra predicate over the combined schema (non-equi
    correlated EXISTS, the TPC-H q21 shape).
    """

    def __init__(
        self,
        probe: ExecutionPlan,
        build: ExecutionPlan,
        probe_keys: Sequence[str],
        build_keys: Sequence[str],
        join_type: str,
        residual: Optional[PhysicalExpr] = None,
        out_capacity: Optional[int] = None,
        num_slots: Optional[int] = None,
        mark_name: str = "__mark",
        expansion_factor: float = 1.0,
        null_aware: bool = False,
    ):
        super().__init__()
        self.probe = probe
        self.build = build
        # NOT IN semantics: a NULL anywhere in the subquery result means no
        # probe row passes, and NULL probe keys never pass.
        self.null_aware = null_aware
        self.probe_keys = list(probe_keys)
        self.build_keys = list(build_keys)
        self.join_type = join_type
        self.residual = residual
        self.mark_name = mark_name
        self.expansion_factor = expansion_factor
        self.num_slots = num_slots or min(
            round_up_pow2(2 * max(build.output_capacity(), 8)), 1 << 21
        )
        if out_capacity is None:
            base = probe.output_capacity()
            # hard ceiling on the EXPANSION (chained joins multiply
            # capacities and the overflow retry quadruples expansion
            # factors); never below the probe side's own capacity
            ceiling = max(
                _MAX_DERIVED_JOIN_CAPACITY, round_up_pow2(max(base, 8))
            )
            out_capacity = min(
                round_up_pow2(max(int(base * expansion_factor), 8)),
                ceiling,
            )
        self.out_capacity = out_capacity

    def children(self):
        return [self.probe, self.build]

    def with_new_children(self, children):
        return HashJoinExec(
            children[0], children[1], self.probe_keys, self.build_keys,
            self.join_type, self.residual, self.out_capacity, self.num_slots,
            self.mark_name, self.expansion_factor, self.null_aware,
        )

    def schema(self):
        if self.join_type in ("semi", "anti"):
            return self.probe.schema()
        if self.join_type == "mark":
            return Schema(
                list(self.probe.schema().fields)
                + [Field(self.mark_name, DataType.BOOL, False)]
            )
        left = list(self.probe.schema().fields)
        right = [
            Field(f.name, f.dtype, True if self.join_type == "left" else f.nullable)
            for f in self.build.schema().fields
        ]
        return Schema(left + right)

    def output_capacity(self):
        if self.join_type in ("semi", "anti", "mark"):
            return self.probe.output_capacity()
        return self.out_capacity

    def _execute(self, ctx: ExecContext) -> Table:
        probe = self.probe.execute(ctx)
        build = self.build.execute(ctx)
        probe, build = _unify_key_dictionaries(
            probe, build, self.probe_keys, self.build_keys
        )
        # shared validity-lane layout: union of both sides' nullability
        lane_plan = []
        for pk, bk in zip(self.probe_keys, self.build_keys):
            lane_plan.append(
                probe.column(pk).validity is not None
                or build.column(bk).validity is not None
            )
        bs = build_join_table(build, self.build_keys, self.num_slots, lane_plan)

        if self.residual is None:
            out, overflow = hash_join(
                probe, bs, self.probe_keys, self.join_type, self.out_capacity
            )
            ctx.record_overflow(self, overflow)
            if self.join_type == "anti" and self.null_aware:
                out = self._null_aware_anti(bs, out)
            if self.join_type == "mark":
                out = out.rename({"__mark": self.mark_name})
            return out

        # Residual path: expand pairs (inner), filter, then fold back.
        pidx = Column(
            torch.arange(probe.capacity, dtype=DataType.INT64.torch_dtype,
                         device=probe.device),
            None, DataType.INT64,
        )
        probe2 = probe.with_column(_PROBE_IDX, pidx)
        pairs, overflow = hash_join(
            probe2, bs, self.probe_keys, "inner", self.out_capacity
        )
        ctx.record_overflow(self, overflow)
        v = self.residual.evaluate(pairs)
        ok = v.data.to(torch.bool) & v.valid_mask() & pairs.row_mask()

        if self.join_type == "inner":
            out = pairs.compact(ok)
            names = [n for n in out.names if n != _PROBE_IDX]
            return out.select(names)

        # semi/anti/mark: scatter pair verdicts back onto probe rows
        pair_pidx = pairs.column(_PROBE_IDX).data.to(torch.int32)
        match = torch.zeros(probe.capacity + 1, dtype=torch.bool,
                            device=probe.device)
        match.index_put_((drop_index(pair_pidx, ok, probe.capacity),),
                         torch.ones_like(ok))
        match = match[:probe.capacity]
        live = probe.row_mask()
        if self.join_type == "semi":
            return probe.compact(match)
        if self.join_type == "anti":
            return probe.compact(live & ~match)
        if self.join_type == "mark":
            return probe.with_column(
                self.mark_name, Column(match, None, DataType.BOOL)
            )
        raise NotImplementedError(
            f"join type {self.join_type} with residual predicate"
        )

    def _null_aware_anti(self, bs, anti_result: Table) -> Table:
        """NOT IN: any NULL in the subquery empties the result; NULL probe
        keys are excluded (three-valued logic makes them UNKNOWN)."""
        keep = ~bs.has_null_key
        probe_null = torch.zeros(anti_result.capacity, dtype=torch.bool,
                                 device=anti_result.device)
        for k in self.probe_keys:
            v = anti_result.column(k).validity
            if v is not None:
                probe_null = probe_null | ~v
        mask = anti_result.row_mask() & ~probe_null & keep
        return anti_result.compact(mask)

    def display(self):
        ks = ", ".join(
            f"{p}={b}" for p, b in zip(self.probe_keys, self.build_keys)
        )
        res = f" residual={self.residual.display()}" if self.residual else ""
        return (
            f"HashJoin {self.join_type} on [{ks}]{res} "
            f"out_cap={self.out_capacity}"
        )


def _unify_key_dictionaries(probe: Table, build: Table, probe_keys, build_keys):
    """String join keys are dictionary codes; codes from different
    dictionaries are not comparable. Remap both sides onto a sorted union
    dictionary (host-side LUT + device gather)."""
    for pk, bk in zip(probe_keys, build_keys):
        pc = probe.column(pk)
        bc = build.column(bk)
        if pc.dictionary is None and bc.dictionary is None:
            continue
        if pc.dictionary == bc.dictionary:
            continue
        if pc.dictionary is None or bc.dictionary is None:
            raise ValueError(
                f"string join key {pk}/{bk} missing a dictionary"
            )
        union_vals = np.unique(
            np.concatenate([pc.dictionary.values, bc.dictionary.values]).astype(str)
        )
        unified = Dictionary(union_vals.astype(object))

        def remap(col, table, name):
            old = col.dictionary.values.astype(str)
            lut = np.searchsorted(union_vals, old).astype(np.int32)
            if not len(lut):
                lut = np.zeros(1, np.int32)
            codes = apply_lut(lut, col.data)
            return table.with_column(
                name, Column(codes, col.validity, col.dtype, unified)
            )

        probe = remap(pc, probe, pk)
        build = remap(bc, build, bk)
    return probe, build


@dataclass(frozen=True)
class MultiwayJoinStep:
    """Parameters of one probe step of a fused multiway join: exactly the
    knobs of the binary HashJoinExec the step replaced, so fusion is
    reversible (``to_binary_chain``) and the fused node sizes its tables
    as the chain it fused does."""

    probe_keys: tuple
    build_keys: tuple
    join_type: str
    out_capacity: int
    num_slots: int
    residual: Optional[PhysicalExpr] = None
    mark_name: str = "__mark"
    expansion_factor: float = 1.0
    null_aware: bool = False

    @classmethod
    def from_join(cls, j: "HashJoinExec") -> "MultiwayJoinStep":
        return cls(
            probe_keys=tuple(j.probe_keys),
            build_keys=tuple(j.build_keys),
            join_type=j.join_type,
            out_capacity=int(j.out_capacity),
            num_slots=int(j.num_slots),
            residual=j.residual,
            mark_name=j.mark_name,
            expansion_factor=float(j.expansion_factor),
            null_aware=bool(j.null_aware),
        )


class MultiwayHashJoinExec(ExecutionPlan):
    """A fused chain of >= 2 hash joins executed as ONE stage. Children are
    ``[probe, build_1 .. build_K]``; ``steps[k]`` joins the running probe
    stream against ``build_k``. The planner's fusion pass
    (planner/distributed._multiway_fusion_pass) builds it.

    It runs as its binary chain (``to_binary_chain``, rebuilt with the
    captured per-step capacities), the reference's default path. A cascade
    that resolves all K probes of the base rows with one K-table probe
    launch was measured slower than the chain on the H100, both where every
    base row matches (a star join) and where the first step keeps 4% of
    them (PERF.md), and is not used.
    """

    def __init__(self, probe: ExecutionPlan, builds: Sequence[ExecutionPlan],
                 steps: Sequence[MultiwayJoinStep]):
        super().__init__()
        if len(builds) != len(steps) or len(steps) < 2:
            raise ValueError(
                f"multiway join needs >= 2 steps with one build each; got "
                f"{len(steps)} steps / {len(builds)} builds"
            )
        self.probe = probe
        self.builds = list(builds)
        self.steps = list(steps)
        self._chain_cache: Optional[HashJoinExec] = None

    def children(self):
        return [self.probe] + list(self.builds)

    def with_new_children(self, children):
        return MultiwayHashJoinExec(children[0], list(children[1:]),
                                    self.steps)

    def to_binary_chain(self, rederive: bool = False) -> HashJoinExec:
        """The equivalent binary HashJoinExec chain. ``rederive=True`` drops
        the captured capacities so the chain re-sizes from its children."""
        cur = self.probe
        for build, s in zip(self.builds, self.steps):
            cur = HashJoinExec(
                cur, build, list(s.probe_keys), list(s.build_keys),
                s.join_type, residual=s.residual,
                out_capacity=None if rederive else s.out_capacity,
                num_slots=None if rederive else s.num_slots,
                mark_name=s.mark_name,
                expansion_factor=s.expansion_factor,
                null_aware=s.null_aware,
            )
        return cur

    def _chain(self) -> HashJoinExec:
        if self._chain_cache is None:
            self._chain_cache = self.to_binary_chain()
        return self._chain_cache

    def schema(self):
        return self._chain().schema()

    def output_capacity(self):
        return self._chain().output_capacity()

    def _execute(self, ctx: ExecContext) -> Table:
        return self._chain()._execute(ctx)

    def display(self):
        parts = []
        for s in self.steps:
            ks = ", ".join(
                f"{p}={b}" for p, b in zip(s.probe_keys, s.build_keys)
            )
            parts.append(f"{s.join_type}[{ks}]")
        return (
            f"MultiwayHashJoin {' -> '.join(parts)} "
            f"out_cap={self.output_capacity()}"
        )


class CrossJoinExec(ExecutionPlan):
    """Cartesian product."""

    def __init__(self, left: ExecutionPlan, right: ExecutionPlan,
                 out_capacity: Optional[int] = None):
        super().__init__()
        self.left = left
        self.right = right
        self.out_capacity = out_capacity or min(
            round_up_pow2(left.output_capacity() * right.output_capacity()),
            1 << 22,
        )

    def children(self):
        return [self.left, self.right]

    def with_new_children(self, children):
        return CrossJoinExec(children[0], children[1], self.out_capacity)

    def schema(self):
        return Schema(
            list(self.left.schema().fields) + list(self.right.schema().fields)
        )

    def output_capacity(self):
        return self.out_capacity

    def _execute(self, ctx: ExecContext) -> Table:
        l = self.left.execute(ctx)
        r = self.right.execute(ctx)
        cap = self.out_capacity
        # Division-based overflow test: l*r > cap iff l > cap // r (no
        # 64-bit product in tpu precision mode).
        rn = torch.clamp(r.num_rows, min=1)
        overflow = (r.num_rows > 0) & (l.num_rows > cap // rn)
        ctx.record_overflow(self, overflow)
        total = torch.where(overflow, cap, l.num_rows * r.num_rows).to(torch.int32)
        j = torch.arange(cap, dtype=torch.int32, device=l.device)
        li = torch.clamp(torch.div(j, rn, rounding_mode="floor"), 0,
                         l.capacity - 1)
        ri = torch.clamp(torch.remainder(j, rn), 0, r.capacity - 1)
        cols: dict[str, Column] = {}
        for name, col in zip(l.names, l.columns):
            cols[name] = col.gather(li)
        for name, col in zip(r.names, r.columns):
            cols[name] = col.gather(ri)
        return Table(tuple(cols.keys()), tuple(cols.values()), total)

    def display(self):
        return f"CrossJoin out_cap={self.out_capacity}"


class UnionExec(ExecutionPlan):
    """UNION ALL: concatenation of same-schema children."""

    def __init__(self, children_: Sequence[ExecutionPlan]):
        super().__init__()
        self._children = list(children_)

    def children(self):
        return list(self._children)

    def with_new_children(self, children):
        return UnionExec(children)

    def schema(self):
        return self._children[0].schema()

    def output_capacity(self):
        return sum(c.output_capacity() for c in self._children)

    def _execute(self, ctx: ExecContext) -> Table:
        tables = [c.execute(ctx) for c in self._children]
        first = tables[0]
        # align column names to the first child's
        aligned = [first]
        for t in tables[1:]:
            aligned.append(Table(first.names, t.columns, t.num_rows))
        return concat_tables(aligned, capacity=self.output_capacity())

    def display(self):
        return f"Union children={len(self._children)}"
