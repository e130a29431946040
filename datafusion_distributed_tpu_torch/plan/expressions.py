"""Physical expression IR, evaluated eagerly to device tensors (port of the
reference `plan/expressions.py`).

- SQL three-valued logic is carried as an explicit (data, validity) pair.
- String comparisons never touch strings on the device: dictionaries are
  sorted, so `col op literal` becomes an int32 code comparison against a
  host-side `searchsorted` of the literal.
- LIKE / IN / SUBSTRING / UPPER / LENGTH / CAST on strings evaluate over the
  *dictionary* on the host and become a lookup-table gather by code — O(NDV)
  host work, O(rows) device work (the code remap of `_remap_codes`).
"""

from __future__ import annotations

import datetime
import re
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from datafusion_distributed_tpu_torch.ops.table import (
    Column,
    Dictionary,
    Table,
    apply_lut,
    lru_get_or_create,
    unify_dictionaries,
)
from datafusion_distributed_tpu_torch.runtime import tracing
from datafusion_distributed_tpu_torch.schema import DataType, Field, Schema

# Dictionary minting is memoized: the same expression over the same input
# dictionary yields the same derived Dictionary object every time.
_LITERAL_DICT_CACHE: dict = {}
_DERIVED_DICT_CACHE: dict = {}


def _literal_dictionary(value: str) -> Dictionary:
    return lru_get_or_create(
        _LITERAL_DICT_CACHE, value,
        lambda: Dictionary.from_strings([value]), cap=512,
    )


def _derived_dictionary(src: Dictionary, op_key, derive):
    """Memoized (source dict, operation) -> (sorted-unique Dictionary,
    int32 inverse LUT). `derive(values) -> array of derived strings`."""

    def mint():
        derived = np.asarray(derive(src.values), dtype=object)
        uniq, inverse = np.unique(derived.astype(str), return_inverse=True)
        return (Dictionary(uniq.astype(object)), inverse.astype(np.int32))

    with tracing.span("expr", "derive", "entries", len(src)):
        return lru_get_or_create(
            _DERIVED_DICT_CACHE, (src.dict_id, op_key), mint, cap=256,
        )


# ---------------------------------------------------------------------------
# Evaluation result: device data + optional validity (None = all valid)
# ---------------------------------------------------------------------------


@dataclass
class ExprValue:
    data: torch.Tensor
    validity: Optional[torch.Tensor]  # bool tensor or None (= all valid)
    dtype: DataType
    dictionary: Optional[Dictionary] = None

    def valid_mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.data.shape, dtype=torch.bool,
                              device=self.data.device)
        return self.validity


def _remap_codes(codes: torch.Tensor, lut) -> torch.Tensor:
    """Apply a unify_dictionaries LUT (None = identity)."""
    if lut is None:
        return codes
    if len(lut) == 0:
        return torch.zeros(codes.shape, dtype=torch.int32, device=codes.device)
    return apply_lut(lut, codes)


def _merge_validity(*vs: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    present = [v for v in vs if v is not None]
    if not present:
        return None
    out = present[0]
    for v in present[1:]:
        out = out & v
    return out


def _full(table: Table, value, dtype: torch.dtype) -> torch.Tensor:
    return torch.full((table.capacity,), value, dtype=dtype,
                      device=table.device)


def _scalar(value, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def parse_date(s: str) -> int:
    """'YYYY-MM-DD' -> int32 days since epoch."""
    d = datetime.date.fromisoformat(s)
    return (d - datetime.date(1970, 1, 1)).days


# ---------------------------------------------------------------------------
# Expression nodes
# ---------------------------------------------------------------------------


class PhysicalExpr:
    """Base class. ``evaluate(table)`` returns an ExprValue whose tensors
    have the table's capacity; garbage rows (>= num_rows) may hold
    anything."""

    def evaluate(self, table: Table) -> ExprValue:
        raise NotImplementedError

    def output_field(self, schema: Schema) -> Field:
        raise NotImplementedError

    def children(self) -> list["PhysicalExpr"]:
        return []

    def display(self) -> str:
        return repr(self)


@dataclass
class Col(PhysicalExpr):
    name: str

    def evaluate(self, table: Table) -> ExprValue:
        c = table.column(self.name)
        return ExprValue(c.data, c.validity, c.dtype, c.dictionary)

    def output_field(self, schema: Schema) -> Field:
        return schema.field(self.name)

    def display(self) -> str:
        return self.name


@dataclass
class Literal(PhysicalExpr):
    value: Any  # python scalar: int/float/bool/str/None; dates pre-parsed int
    dtype: DataType

    def evaluate(self, table: Table) -> ExprValue:
        if self.value is None:
            data = _full(table, 0, self.dtype.torch_dtype)
            return ExprValue(data, _full(table, False, torch.bool), self.dtype)
        if self.dtype == DataType.STRING:
            # bare string literal: an interned single-entry dictionary;
            # comparisons against columns resolve via the column's dictionary
            d = _literal_dictionary(self.value)
            return ExprValue(_full(table, 0, torch.int32), None, self.dtype, d)
        val = np.asarray(self.value, dtype=self.dtype.np_dtype)
        return ExprValue(_full(table, val.item(), self.dtype.torch_dtype),
                         None, self.dtype)

    def output_field(self, schema: Schema) -> Field:
        return Field(str(self.value), self.dtype, nullable=self.value is None)

    def display(self) -> str:
        return repr(self.value)


_ARITH_OPS = {"+", "-", "*", "/", "%"}
_CMP_OPS = {"==", "!=", "<", "<=", ">", ">="}


def _promote(a: DataType, b: DataType) -> DataType:
    order = [
        DataType.BOOL,
        DataType.INT32,
        DataType.DATE32,
        DataType.INT64,
        DataType.FLOAT32,
        DataType.FLOAT64,
    ]
    if a == b:
        return a
    # untyped NULL adopts the peer's type (SQL NULL literal typing)
    if a == DataType.NULL:
        return b
    if b == DataType.NULL:
        return a
    if a == DataType.STRING or b == DataType.STRING:
        return DataType.STRING
    return max(a, b, key=order.index)


@dataclass
class BinaryOp(PhysicalExpr):
    """Arithmetic/comparison. String comparisons compile to code comparisons
    against the column dictionary (sorted => order-preserving)."""

    op: str
    left: PhysicalExpr
    right: PhysicalExpr

    def children(self):
        return [self.left, self.right]

    def evaluate(self, table: Table) -> ExprValue:
        l = self.left.evaluate(table)
        r = self.right.evaluate(table)
        validity = _merge_validity(l.validity, r.validity)
        if self.op in _CMP_OPS:
            data = self._compare(l, r, table)
            return ExprValue(data, validity, DataType.BOOL)
        out_dtype = _promote(l.dtype, r.dtype)
        if self.op == "/" and out_dtype.is_integer:
            out_dtype = DataType.FLOAT64
        tdt = out_dtype.torch_dtype
        ldata = l.data.to(tdt)
        rdata = r.data.to(tdt)
        if self.op == "+":
            data = ldata + rdata
        elif self.op == "-":
            data = ldata - rdata
        elif self.op == "*":
            data = ldata * rdata
        elif self.op == "/":
            data = ldata / torch.where(rdata == 0, _scalar(1, rdata), rdata)
            validity = _merge_validity(validity, r.data != 0)
        elif self.op == "%":
            safe = torch.where(rdata == 0, _scalar(1, rdata), rdata)
            data = torch.where(rdata == 0, _scalar(0, rdata),
                               torch.remainder(ldata, safe))
            validity = _merge_validity(validity, r.data != 0)
        else:
            raise NotImplementedError(self.op)
        return ExprValue(data, validity, out_dtype)

    def _compare(self, l: ExprValue, r: ExprValue, table: Table):
        # SQL coercion: DATE <op> 'yyyy-mm-dd' parses the string literal.
        if l.dtype == DataType.DATE32 and isinstance(self.right, Literal) and (
            self.right.dtype == DataType.STRING
        ):
            days = parse_date(self.right.value)
            return _apply_cmp(self.op, l.data, days)
        if r.dtype == DataType.DATE32 and isinstance(self.left, Literal) and (
            self.left.dtype == DataType.STRING
        ):
            days = parse_date(self.left.value)
            return _apply_cmp(_flip_cmp(self.op), r.data, days)
        if l.dtype == DataType.STRING or r.dtype == DataType.STRING:
            return self._compare_strings(l, r)
        common = _promote(l.dtype, r.dtype).torch_dtype
        return _apply_cmp(self.op, l.data.to(common), r.data.to(common))

    def _compare_strings(self, l: ExprValue, r: ExprValue):
        lit_side = None
        col_side = None
        if isinstance(self.right, Literal) and self.right.dtype == DataType.STRING:
            lit_side, col_side, op = self.right, l, self.op
        elif isinstance(self.left, Literal) and self.left.dtype == DataType.STRING:
            lit_side, col_side, op = self.left, r, _flip_cmp(self.op)
        if lit_side is not None:
            d = col_side.dictionary
            if d is None:
                raise ValueError("string column missing dictionary")
            lit = lit_side.value
            codes = col_side.data
            if op in ("==", "!="):
                code = d.code_of(lit)
                if code < 0:
                    same = torch.zeros(codes.shape, dtype=torch.bool,
                                       device=codes.device)
                else:
                    same = codes == code
                return same if op == "==" else ~same
            # Order comparison: sorted dictionary => searchsorted boundary.
            pos_left = int(np.searchsorted(d.values.astype(str), lit, side="left"))
            pos_right = int(np.searchsorted(d.values.astype(str), lit, side="right"))
            if op == "<":
                return codes < pos_left
            if op == "<=":
                return codes < pos_right
            if op == ">":
                return codes >= pos_right
            if op == ">=":
                return codes >= pos_left
            raise NotImplementedError(op)
        # column vs column: map both code spaces to ranks in the sorted
        # union vocabulary (equal strings -> equal ranks, order preserved)
        if l.dictionary is None or r.dictionary is None:
            raise ValueError("string column comparison requires dictionaries")
        _, luts = unify_dictionaries([l.dictionary, r.dictionary])
        a = _remap_codes(l.data, luts[0])
        b = _remap_codes(r.data, luts[1])
        return _apply_cmp(self.op, a, b)

    def output_field(self, schema: Schema) -> Field:
        lf = self.left.output_field(schema)
        rf = self.right.output_field(schema)
        nullable = lf.nullable or rf.nullable or self.op in ("/", "%")
        if self.op in _CMP_OPS:
            return Field(self.display(), DataType.BOOL, nullable)
        out = _promote(lf.dtype, rf.dtype)
        if self.op == "/" and out.is_integer:
            out = DataType.FLOAT64
        return Field(self.display(), out, nullable)

    def display(self) -> str:
        return f"({self.left.display()} {self.op} {self.right.display()})"


def _apply_cmp(op: str, a, b):
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    raise NotImplementedError(op)


def _flip_cmp(op: str) -> str:
    return {"==": "==", "!=": "!=", "<": ">", "<=": ">=", ">": "<", ">=": "<="}[op]


@dataclass
class BooleanOp(PhysicalExpr):
    """AND/OR with SQL Kleene three-valued logic."""

    op: str  # "and" | "or"
    left: PhysicalExpr
    right: PhysicalExpr

    def children(self):
        return [self.left, self.right]

    def evaluate(self, table: Table) -> ExprValue:
        l = self.left.evaluate(table)
        r = self.right.evaluate(table)
        lv, rv = l.valid_mask(), r.valid_mask()
        ld = l.data.to(torch.bool)
        rd = r.data.to(torch.bool)
        if self.op == "and":
            data = ld & rd
            # null AND true = null; null AND false = false
            validity = (lv & rv) | (lv & ~ld) | (rv & ~rd)
        elif self.op == "or":
            data = ld | rd
            validity = (lv & rv) | (lv & ld) | (rv & rd)
        else:
            raise NotImplementedError(self.op)
        if l.validity is None and r.validity is None:
            validity = None
        return ExprValue(data, validity, DataType.BOOL)

    def output_field(self, schema: Schema) -> Field:
        return Field(self.display(), DataType.BOOL, True)

    def display(self) -> str:
        return f"({self.left.display()} {self.op.upper()} {self.right.display()})"


@dataclass
class Not(PhysicalExpr):
    child: PhysicalExpr

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        return ExprValue(~c.data.to(torch.bool), c.validity, DataType.BOOL)

    def output_field(self, schema: Schema) -> Field:
        return Field(self.display(), DataType.BOOL, True)

    def display(self) -> str:
        return f"NOT {self.child.display()}"


@dataclass
class IsNull(PhysicalExpr):
    child: PhysicalExpr
    negated: bool = False

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        isnull = (
            ~c.valid_mask() if c.validity is not None
            else torch.zeros(c.data.shape, dtype=torch.bool,
                             device=c.data.device)
        )
        return ExprValue(~isnull if self.negated else isnull, None, DataType.BOOL)

    def output_field(self, schema: Schema) -> Field:
        return Field(self.display(), DataType.BOOL, False)

    def display(self) -> str:
        return f"{self.child.display()} IS {'NOT ' if self.negated else ''}NULL"


@dataclass
class Cast(PhysicalExpr):
    child: PhysicalExpr
    to: DataType

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        if c.dtype == self.to:
            return c
        if c.dtype == DataType.NULL:
            # an untyped NULL casts to anything: all-null column of the
            # target type
            data = torch.zeros(c.data.shape, dtype=self.to.torch_dtype,
                               device=c.data.device)
            return ExprValue(data, c.valid_mask() & False, self.to)
        if c.dtype == DataType.STRING:
            # dictionary-LUT cast: parse each vocab entry on the host, the
            # device gathers by code (unparseable entries -> null)
            if c.dictionary is None:
                raise NotImplementedError("string cast without dictionary")
            with tracing.span("expr", "cast", "entries",
                              len(c.dictionary)):
                vals = c.dictionary.values.astype(str)
                parsed = np.zeros(max(len(vals), 1), dtype=self.to.np_dtype)
                ok = np.zeros(max(len(vals), 1), dtype=np.bool_)
                for i, v in enumerate(vals):
                    try:
                        if self.to == DataType.DATE32:
                            parsed[i] = parse_date(v)
                        elif self.to.is_float:
                            parsed[i] = float(v)
                        else:
                            parsed[i] = int(float(v))
                        ok[i] = True
                    except (ValueError, OverflowError):
                        pass
            data = apply_lut(parsed, c.data)
            valid = apply_lut(ok, c.data)
            validity = _merge_validity(c.validity, valid)
            return ExprValue(data, validity, self.to)
        if self.to == DataType.STRING:
            raise NotImplementedError("cast to string is not supported")
        return ExprValue(c.data.to(self.to.torch_dtype), c.validity, self.to)

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(f.name, self.to, f.nullable)

    def display(self) -> str:
        return f"CAST({self.child.display()} AS {self.to.value})"


def _sql_like_to_regex(pattern: str) -> str:
    out = []
    i = 0
    while i < len(pattern):
        ch = pattern[i]
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        elif ch == "\\" and i + 1 < len(pattern):
            out.append(re.escape(pattern[i + 1]))
            i += 1
        else:
            out.append(re.escape(ch))
        i += 1
    return "".join(out)


@dataclass
class Like(PhysicalExpr):
    """LIKE on a dictionary column: regex over the host dictionary ->
    boolean LUT -> device gather by code."""

    child: PhysicalExpr
    pattern: str
    negated: bool = False

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        if c.dtype != DataType.STRING or c.dictionary is None:
            raise ValueError("LIKE requires a dictionary string column")
        with tracing.span("expr", "like", "entries", len(c.dictionary)):
            rx = re.compile(_sql_like_to_regex(self.pattern), re.DOTALL)
            lut = np.asarray(
                [bool(rx.fullmatch(v)) for v in c.dictionary.values],
                dtype=np.bool_,
            )
        if self.negated:
            lut = ~lut
        if len(lut) == 0:
            data = torch.full(c.data.shape, bool(self.negated),
                              device=c.data.device)
        else:
            data = apply_lut(lut, c.data)
        return ExprValue(data, c.validity, DataType.BOOL)

    def output_field(self, schema: Schema) -> Field:
        return Field(self.display(), DataType.BOOL, True)

    def display(self) -> str:
        return (
            f"{self.child.display()} {'NOT ' if self.negated else ''}"
            f"LIKE {self.pattern!r}"
        )


@dataclass
class InList(PhysicalExpr):
    child: PhysicalExpr
    values: tuple
    negated: bool = False

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        if c.dtype == DataType.STRING:
            if c.dictionary is None:
                raise ValueError("IN on string requires dictionary")
            with tracing.span("expr", "in", "entries", len(c.dictionary)):
                codes = [c.dictionary.code_of(v) for v in self.values]
                codes = [x for x in codes if x >= 0]
            if not codes:
                data = torch.zeros(c.data.shape, dtype=torch.bool,
                                   device=c.data.device)
            else:
                data = torch.isin(c.data, torch.tensor(
                    codes, dtype=c.data.dtype, device=c.data.device))
        else:
            items = list(self.values)
            if c.dtype == DataType.DATE32:
                # date IN ('yyyy-mm-dd', ...) — parse string items to days
                items = [
                    parse_date(v) if isinstance(v, str) else v for v in items
                ]
            vals = np.asarray(items, dtype=c.dtype.np_dtype)
            data = torch.isin(c.data, torch.from_numpy(vals).to(c.data.device))
        if self.negated:
            data = ~data
        return ExprValue(data, c.validity, DataType.BOOL)

    def output_field(self, schema: Schema) -> Field:
        return Field(self.display(), DataType.BOOL, True)

    def display(self) -> str:
        neg = "NOT " if self.negated else ""
        return f"{self.child.display()} {neg}IN {self.values!r}"


@dataclass
class Case(PhysicalExpr):
    """CASE WHEN ... THEN ... [ELSE ...] END (searched form)."""

    branches: tuple  # tuple[(cond PhysicalExpr, value PhysicalExpr), ...]
    otherwise: Optional[PhysicalExpr] = None

    def children(self):
        out = []
        for c, v in self.branches:
            out += [c, v]
        if self.otherwise:
            out.append(self.otherwise)
        return out

    def evaluate(self, table: Table) -> ExprValue:
        results = [(c.evaluate(table), v.evaluate(table)) for c, v in self.branches]
        out_dtype = results[0][1].dtype
        for _, v in results[1:]:
            out_dtype = _promote(out_dtype, v.dtype)
        if self.otherwise is not None:
            else_v = self.otherwise.evaluate(table)
            out_dtype = _promote(out_dtype, else_v.dtype)
            data = else_v.data.to(out_dtype.torch_dtype)
            validity = else_v.valid_mask()
        else:
            data = _full(table, 0, out_dtype.torch_dtype)
            validity = _full(table, False, torch.bool)
        # Apply branches in reverse so the FIRST matching branch wins.
        for cond, val in reversed(results):
            take = cond.data.to(torch.bool) & cond.valid_mask()
            data = torch.where(take, val.data.to(out_dtype.torch_dtype), data)
            validity = torch.where(take, val.valid_mask(), validity)
        return ExprValue(data, validity, out_dtype)

    def output_field(self, schema: Schema) -> Field:
        out = self.branches[0][1].output_field(schema).dtype
        for _, v in self.branches[1:]:
            out = _promote(out, v.output_field(schema).dtype)
        if self.otherwise is not None:
            out = _promote(out, self.otherwise.output_field(schema).dtype)
        return Field(self.display(), out, True)

    def display(self) -> str:
        parts = " ".join(
            f"WHEN {c.display()} THEN {v.display()}" for c, v in self.branches
        )
        e = f" ELSE {self.otherwise.display()}" if self.otherwise else ""
        return f"CASE {parts}{e} END"


def _civil_from_days(z: torch.Tensor):
    """days-since-epoch -> (year, month, day), integer-only (Howard
    Hinnant's public-domain civil_from_days algorithm)."""
    z = z.to(torch.int32) + 719468
    era = torch.div(z, 146097, rounding_mode="floor")
    doe = z - era * 146097
    yoe = torch.div(
        doe - torch.div(doe, 1460, rounding_mode="floor")
        + torch.div(doe, 36524, rounding_mode="floor")
        - torch.div(doe, 146096, rounding_mode="floor"),
        365, rounding_mode="floor",
    )
    y = yoe + era * 400
    doy = doe - (365 * yoe + torch.div(yoe, 4, rounding_mode="floor")
                 - torch.div(yoe, 100, rounding_mode="floor"))
    mp = torch.div(5 * doy + 2, 153, rounding_mode="floor")
    d = doy - torch.div(153 * mp + 2, 5, rounding_mode="floor") + 1
    m = mp + torch.where(mp < 10, 3, -9).to(mp.dtype)
    y = y + (m <= 2).to(y.dtype)
    return y, m, d


@dataclass
class Extract(PhysicalExpr):
    """EXTRACT(part FROM x). DATE32 children are days since epoch; integer
    children are epoch SECONDS."""

    part: str
    child: PhysicalExpr

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        if c.dtype == DataType.DATE32:
            days = c.data
            secs_of_day = None
        else:
            secs = c.data.to(torch.int32)
            days = torch.div(secs, 86400, rounding_mode="floor")
            secs_of_day = torch.remainder(secs, 86400)
        if self.part in ("hour", "minute", "second"):
            if secs_of_day is None:
                secs_of_day = torch.zeros_like(days)
            out = {
                "hour": lambda: torch.div(secs_of_day, 3600,
                                          rounding_mode="floor"),
                "minute": lambda: torch.remainder(
                    torch.div(secs_of_day, 60, rounding_mode="floor"), 60),
                "second": lambda: torch.remainder(secs_of_day, 60),
            }[self.part]()
        else:
            y, m, d = _civil_from_days(days)
            out = {"year": y, "month": m, "day": d}[self.part]
        return ExprValue(out.to(DataType.INT64.torch_dtype), c.validity,
                         DataType.INT64)

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(self.display(), DataType.INT64, f.nullable)

    def display(self) -> str:
        return f"EXTRACT({self.part} FROM {self.child.display()})"


@dataclass
class DateTrunc(PhysicalExpr):
    """DATE_TRUNC(unit, x) over epoch-seconds integers or DATE32 days."""

    unit: str
    child: PhysicalExpr

    _SECONDS = {"second": 1, "minute": 60, "hour": 3600, "day": 86400}

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        unit = self.unit.lower()
        if c.dtype == DataType.DATE32:
            if unit in ("second", "minute", "hour", "day"):
                return c
            raise NotImplementedError(f"DATE_TRUNC {unit} on date32")
        step = self._SECONDS.get(unit)
        if step is None:
            raise NotImplementedError(f"DATE_TRUNC unit {unit}")
        data = c.data - torch.remainder(c.data, step)
        return ExprValue(data, c.validity, c.dtype)

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(self.display(), f.dtype, f.nullable)

    def display(self) -> str:
        return f"DATE_TRUNC('{self.unit}', {self.child.display()})"


def _derived_codes(c: ExprValue, op_key, derive) -> ExprValue:
    """Host-side dictionary transform + device code remap (SUBSTRING,
    UPPER/LOWER, REGEXP_REPLACE)."""
    new_dict, inverse = _derived_dictionary(c.dictionary, op_key, derive)
    if len(c.dictionary.values) == 0:
        return ExprValue(c.data, c.validity, DataType.STRING, new_dict)
    return ExprValue(apply_lut(inverse, c.data), c.validity, DataType.STRING,
                     new_dict)


@dataclass
class Substring(PhysicalExpr):
    """SUBSTRING on a dictionary string column (derived dictionary)."""

    child: PhysicalExpr
    start: int  # 1-based, SQL semantics
    length: Optional[int]

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        if c.dtype != DataType.STRING or c.dictionary is None:
            raise ValueError("SUBSTRING requires a dictionary string column")
        # SQL semantics: positions before 1 exist but hold nothing, so a
        # start of 0 with FOR 2 yields just the first character.
        begin = self.start - 1
        b = max(begin, 0)
        if self.length is None:
            derive = lambda vs: [v[b:] for v in vs]  # noqa: E731
        else:
            end = begin + self.length
            derive = lambda vs: [  # noqa: E731
                v[b:end] if end > b else "" for v in vs
            ]
        return _derived_codes(c, ("substr", self.start, self.length), derive)

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(self.display(), DataType.STRING, f.nullable)

    def display(self) -> str:
        ln = f" FOR {self.length}" if self.length is not None else ""
        return f"SUBSTRING({self.child.display()} FROM {self.start}{ln})"


@dataclass
class Coalesce(PhysicalExpr):
    """COALESCE(a, b, ...): first non-null value per row. String children
    resolve through a union dictionary."""

    args: tuple

    def children(self):
        return list(self.args)

    def evaluate(self, table: Table) -> ExprValue:
        vals = [a.evaluate(table) for a in self.args]
        if any(v.dtype == DataType.STRING for v in vals):
            return self._evaluate_strings(vals, table)
        out_dtype = vals[0].dtype
        for v in vals[1:]:
            out_dtype = _promote(out_dtype, v.dtype)
        tdt = out_dtype.torch_dtype
        data = vals[-1].data.to(tdt)
        validity = vals[-1].valid_mask()
        for v in reversed(vals[:-1]):
            take = v.valid_mask()
            data = torch.where(take, v.data.to(tdt), data)
            validity = take | validity
        if any(v.validity is None for v in vals):
            validity = None  # some child is always valid -> result is too
        return ExprValue(data, validity, out_dtype)

    def _evaluate_strings(self, vals, table: Table) -> ExprValue:
        if not all(v.dtype == DataType.STRING for v in vals):
            raise ValueError("COALESCE mixes string and non-string types")
        union, luts = unify_dictionaries([v.dictionary for v in vals])
        data = _full(table, 0, torch.int32)
        validity = _full(table, False, torch.bool)
        for v, lut in zip(reversed(vals), reversed(luts)):
            codes = _remap_codes(v.data, lut)
            take = v.valid_mask()
            data = torch.where(take, codes.to(torch.int32), data)
            validity = take | validity
        out_validity = None if any(v.validity is None for v in vals) else (
            validity
        )
        return ExprValue(data, out_validity, DataType.STRING, union)

    def output_field(self, schema: Schema) -> Field:
        f0 = self.args[0].output_field(schema)
        out = f0.dtype
        for a in self.args[1:]:
            fa = a.output_field(schema)
            if out != DataType.STRING or fa.dtype != DataType.STRING:
                out = _promote(out, fa.dtype)
        nullable = all(a.output_field(schema).nullable for a in self.args)
        return Field(self.display(), out, nullable)

    def display(self) -> str:
        inner = ", ".join(a.display() for a in self.args)
        return f"COALESCE({inner})"


@dataclass
class Abs(PhysicalExpr):
    child: PhysicalExpr

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        return ExprValue(torch.abs(c.data), c.validity, c.dtype)

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(self.display(), f.dtype, f.nullable)

    def display(self) -> str:
        return f"ABS({self.child.display()})"


@dataclass
class Round(PhysicalExpr):
    child: PhysicalExpr
    digits: int = 0

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        if c.dtype.is_integer:
            return c
        scale = 10.0 ** self.digits
        data = torch.round(c.data * scale) / scale
        return ExprValue(data, c.validity, c.dtype)

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(self.display(), f.dtype, f.nullable)

    def display(self) -> str:
        return f"ROUND({self.child.display()}, {self.digits})"


@dataclass
class StringCase(PhysicalExpr):
    """UPPER/LOWER on a dictionary string column (derived dictionary)."""

    child: PhysicalExpr
    upper: bool

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        if c.dtype != DataType.STRING or c.dictionary is None:
            raise ValueError("UPPER/LOWER requires a dictionary string column")
        return _derived_codes(
            c, ("case", self.upper),
            lambda vs: (np.char.upper if self.upper else np.char.lower)(
                vs.astype(str)
            ),
        )

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(self.display(), DataType.STRING, f.nullable)

    def display(self) -> str:
        fn = "UPPER" if self.upper else "LOWER"
        return f"{fn}({self.child.display()})"


@dataclass
class StrLength(PhysicalExpr):
    """LENGTH(str): dictionary-LUT transform."""

    child: PhysicalExpr

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        if c.dtype != DataType.STRING or c.dictionary is None:
            raise ValueError("LENGTH requires a dictionary string column")
        with tracing.span("expr", "length", "entries", len(c.dictionary)):
            vals = c.dictionary.values.astype(str)
            lut = np.asarray([len(v) for v in vals], dtype=np.int32)
        if len(lut) == 0:
            data = torch.zeros(c.data.shape, dtype=torch.int32,
                               device=c.data.device)
        else:
            data = apply_lut(lut, c.data)
        return ExprValue(data, c.validity, DataType.INT32)

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(self.display(), DataType.INT32, f.nullable)

    def display(self) -> str:
        return f"LENGTH({self.child.display()})"


@dataclass
class RegexpReplace(PhysicalExpr):
    """REGEXP_REPLACE(str, pattern, replacement): host re.sub over the
    dictionary, derived dictionary + code remap."""

    child: PhysicalExpr
    pattern: str
    replacement: str

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        if c.dtype != DataType.STRING or c.dictionary is None:
            raise ValueError(
                "REGEXP_REPLACE requires a dictionary string column"
            )
        rx = re.compile(self.pattern)
        repl = self.replacement
        return _derived_codes(
            c, ("re", self.pattern, repl),
            lambda vs: [rx.sub(repl, v) for v in vs.astype(str)],
        )

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(self.display(), DataType.STRING, f.nullable)

    def display(self) -> str:
        return (
            f"REGEXP_REPLACE({self.child.display()}, "
            f"{self.pattern!r}, {self.replacement!r})"
        )


_CONCAT_COMBO_CAP = 1 << 22
_CONCAT_DICT_CACHE: dict = {}


def _concat_dictionary(dict_parts: list, total: int) -> tuple:
    """(Dictionary, int32 inverse LUT) of every combination of the parts'
    entries, in the cross product's order."""
    import itertools as _it

    combos = [""] * total
    for flat, parts in enumerate(
        _it.product(*[d if len(d) else [""] for _, d in dict_parts])
    ):
        combos[flat] = "".join(parts)
    uniq, inverse = np.unique(
        np.asarray(combos, dtype=object).astype(str), return_inverse=True,
    )
    return Dictionary(uniq.astype(object)), inverse.astype(np.int32)


@dataclass
class ConcatStrings(PhysicalExpr):
    """CONCAT over string columns/literals: the combined dictionary is the
    cross product of the children's dictionaries (built on the host), and
    per-row codes compose positionally — a few integer ops + one gather on
    the device."""

    args: tuple

    def children(self):
        return list(self.args)

    def evaluate(self, table: Table) -> ExprValue:
        vals = [a.evaluate(table) for a in self.args]
        dict_parts = []  # (index into vals, values array)
        for i, v in enumerate(vals):
            if v.dtype != DataType.STRING or v.dictionary is None:
                raise ValueError("CONCAT requires string children")
            dict_parts.append((i, v.dictionary.values.astype(str)))
        sizes = [max(len(d), 1) for _, d in dict_parts]
        total = 1
        for s in sizes:
            total *= s
        if total > _CONCAT_COMBO_CAP:
            raise ValueError(
                f"CONCAT dictionary cross product {total} exceeds cap "
                f"{_CONCAT_COMBO_CAP}"
            )
        # combo index = sum(code_i * stride_i), strides right-to-left
        strides = [1] * len(sizes)
        for i in range(len(sizes) - 2, -1, -1):
            strides[i] = strides[i + 1] * sizes[i + 1]
        cache_key = tuple(v.dictionary.dict_id for v in vals)
        cached = _CONCAT_DICT_CACHE.get(cache_key)
        if cached is None:
            with tracing.span("expr", "concat", "entries", total):
                cached = _concat_dictionary(dict_parts, total)
            if len(_CONCAT_DICT_CACHE) > 64:
                _CONCAT_DICT_CACHE.clear()
            _CONCAT_DICT_CACHE[cache_key] = cached
        new_dict, inverse_np = cached
        flat_code = _full(table, 0, torch.int32)
        for (i, d), size, stride in zip(dict_parts, sizes, strides):
            code = torch.clamp(vals[i].data, 0, size - 1)
            flat_code = flat_code + code * stride
        codes = apply_lut(inverse_np, flat_code)
        validity = _merge_validity(*[v.validity for v in vals])
        return ExprValue(codes, validity, DataType.STRING, new_dict)

    def output_field(self, schema: Schema) -> Field:
        nullable = any(a.output_field(schema).nullable for a in self.args)
        return Field(self.display(), DataType.STRING, nullable)

    def display(self) -> str:
        inner = ", ".join(a.display() for a in self.args)
        return f"CONCAT({inner})"


@dataclass
class Alias(PhysicalExpr):
    child: PhysicalExpr
    name: str

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        return self.child.evaluate(table)

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(self.name, f.dtype, f.nullable)

    def display(self) -> str:
        return f"{self.child.display()} AS {self.name}"


@dataclass
class Negate(PhysicalExpr):
    child: PhysicalExpr

    def children(self):
        return [self.child]

    def evaluate(self, table: Table) -> ExprValue:
        c = self.child.evaluate(table)
        return ExprValue(-c.data, c.validity, c.dtype)

    def output_field(self, schema: Schema) -> Field:
        f = self.child.output_field(schema)
        return Field(f"(- {f.name})", f.dtype, f.nullable)

    def display(self) -> str:
        return f"(- {self.child.display()})"


def expr_to_column(value: ExprValue) -> Column:
    return Column(value.data, value.validity, value.dtype, value.dictionary)
