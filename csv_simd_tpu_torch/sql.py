"""SQL front-end over the device relational layer
(csv_simd_tpu/sql.py, in the PyTorch port).

The statement compiler and the host executors are the JAX package's,
unchanged; the primitives they call are the port's (query, frame,
corpus_api, join, window, setops), and `sql(..., device="cuda")` names
the device every tape, predicate, sort, group-by, join, window and set
operation of the statement runs on. `explain()` and EXPLAIN ANALYZE
print the JAX package's text.

One entry point: `sql(query, source_or_tables)` compiles a SELECT
statement onto the existing primitives — nothing here touches bytes:
WHERE trees push down to device predicate masks (query.select_records),
GROUP BY/HAVING run the device group-by (query.groupby_typed), ORDER
BY/LIMIT ride the device sort (frame.read_typed), and JOIN maps to the
device sort-merge (join.join_typed). The reference has no analog (its
CLI is a stub, bin/main.rs:11-14); this is the capstone of the
relational layer.

Supported grammar (case-insensitive keywords):

    [WITH name AS ( select [UNION ...] ) [, name2 AS ( ... )]]
    select [UNION ALL select ...]   where each select is:
    SELECT [DISTINCT] * | item [, item ...]
    FROM table [[AS] alias]
        [ [INNER|LEFT|RIGHT|FULL [OUTER]|SEMI|ANTI] JOIN table [[AS] alias]
                 ON a.col = b.col [AND a.col2 = b.col2 ...]
                 | USING (col [, col ...])
          | CROSS JOIN table [[AS] alias] ]
    [WHERE expr] [GROUP BY col|alias [, ...]] [HAVING agg_expr]
    [ORDER BY ocol [ASC|DESC] [NULLS FIRST|LAST] [, ...]]
    [LIMIT n [OFFSET m]]

- item: column | arithmetic expression (`qty * price`, `(a + b) / 2`,
  unary minus; int math runs in int32 with two's-complement wrap, any
  float operand or division promotes to float32, x/0 or a NULL operand
  makes the row NULL; LENGTH(col) / CHAR_LENGTH(col) — the DECODED
  byte length of a str/bytes column, an int32 leaf usable anywhere an
  expression is; scalar numeric functions compose anywhere in an
  expression: ABS(x) — operand's type, int32 wrap at the minimum;
  FLOOR(x)/CEIL(x)/CEILING(x) — identity on ints, float32 floor/ceil
  on floats; ROUND(x [, d]) — d decimal places (negative d rounds to
  tens/hundreds), identity on ints with d >= 0, else float32
  round-half-to-even; MOD(a, b) or a % b — truncated remainder with
  the dividend's sign, b = 0 makes the row NULL like division;
  CAST(expr AS INTEGER|FLOAT/REAL) composes anywhere in an
  expression: float -> int truncates toward zero saturating at the
  int32 limits, int -> float32)
  | agg(column) | agg(expression) — SUM(qty*price)
  etc. evaluate the expression on device before the group reduce |
  COALESCE(col, col [, ...]) |
  CASE WHEN expr THEN val [...] [ELSE val] END [AS alias]
  (CASE values: literals — numbers make a float column, strings a
  text one — or same-typed column refs, or a mix where literals
  convert into the columns' type; no match and no ELSE is NULL)
  with agg in SUM/MIN/MAX/COUNT/AVG/MEAN; COUNT(*) counts group rows.
  MIN/MAX over a TEXT column reduce lexicographically (scalar: a
  device group-by keyed by the column + O(#distinct) host reduce;
  per group: a pair group-by over (group keys + col), like
  COUNT(DISTINCT)); SUM/AVG over text raise.
  GROUP_CONCAT(col [, 'sep']) / STRING_AGG — per-group (or whole-
  table) concatenation of the non-NULL values in RECORD order
  (SQLite's arrival semantics, separator default ','; numerics
  stringify; all-NULL groups yield NULL; base-table GROUP BY only —
  joins/corpus merges raise).
  COUNT(DISTINCT col) counts distinct non-NULL values (NULL =
  typed-parse failure): scalar or per group, it rides a device
  group-by whose key is (group keys + col) — one row per distinct
  pair — with an O(#pairs) host tally; over a JOIN it reduces on the
  joined frame. SUM/AVG(DISTINCT ...) are not supported.
  COALESCE takes the first non-NULL column per row (same column type
  required; plain selections and joins — e.g. merging the two key
  columns of a FULL OUTER JOIN); IFNULL(a, b) is its two-column
  form. NULLIF(a, b) is column a, NULL where it equals b (a column,
  number or 'string') — sugar for CASE WHEN a != b THEN a END. Text functions are also SELECT items
  (plain selections and joins; not with GROUP BY), applied on host at
  materialization (the values land on host anyway): UPPER(col)/
  LOWER(col) — ASCII-only fold of the decoded text; TRIM/LTRIM/
  RTRIM(col) — strip ASCII spaces (SQL's default charset; note the
  default str spec already trims OUTER spaces at decode — pass
  Col("str", trim=False) in the schema to keep them);
  SUBSTR(col, start [, len]) / SUBSTRING — 1-based start;
  REPLACE(col, 'from', 'to') — all occurrences, an empty 'from'
  returns the text unchanged (SQLite); INSTR(col, 'sub') — 1-based
  position of the first occurrence, 0 when absent (an INT column,
  usable as an ORDER BY key but not inside CONCAT);
  CONCAT(part, part, ...) and the `a || b || 'x'` operator — parts
  are text columns, 'string literals', or nested text functions
  (a row is NULL if any column part is NULL).
- WINDOW functions are SELECT items on plain selections, joins and
  derived tables (not with GROUP BY — wrap the grouped select in a
  derived table): `agg(col) OVER ([PARTITION BY cols] [ORDER BY col
  [ASC|DESC], ...])` for SUM/MIN/MAX/COUNT/AVG (COUNT(*) too), plus
  ROW_NUMBER(), RANK(), DENSE_RANK(), PERCENT_RANK(), CUME_DIST(),
  NTILE(n) (ORDER BY required),
  LAG/LEAD(col [, n]) (default n=1), and FIRST_VALUE/LAST_VALUE(col)
  / NTH_VALUE(col, n) — frame-position values that do NOT skip NULLs;
  their default frame ends at the current peer group (give LAST_VALUE
  an explicit ROWS ... UNBOUNDED FOLLOWING frame for the usual
  partition-last semantics). Rows keep their original order;
  the window orders internally (stable, NULLs last). Aggregates with
  an OVER ORDER BY are cumulative with SQL's default RANGE frame
  (peer rows — equal order keys — share the value); without one they
  cover the whole partition. Explicit frames: `ROWS BETWEEN <bound>
  AND <bound>` (bounds: UNBOUNDED PRECEDING, k PRECEDING, CURRENT
  ROW, k FOLLOWING, UNBOUNDED FOLLOWING; single-bound shorthand
  `ROWS <bound>` = .. AND CURRENT ROW) — strictly row-positional, no
  peer sharing, NULL values skipped, empty frame -> NULL (COUNT 0);
  RANGE spellings of the default and of UNBOUNDED..UNBOUNDED are
  accepted, value-offset RANGE frames raise. LAG/LEAD step over ROWS;
  out-of-partition offsets are NULL. Frames and windows execute on
  DEVICE when eligible (window.py: one sort + segmented scans;
  bounded-window min/max stays on host), host pass otherwise.
- ORDER BY accepts output aliases, plain columns (device sort, top-k
  under LIMIT), and computed keys — arithmetic expressions,
  LENGTH(col), UPPER/LOWER(col) — which sort on host over the
  materialized frame, NULL keys last in both directions.
- table: a bare identifier resolved through the `tables` mapping, or a
  'quoted path' / "quoted path" opened as a CSV file — either may take
  an `[AS] alias` that qualified refs then use (the bare name stops
  qualifying once aliased; two join sides may not share an alias;
  SELF-joins work by aliasing the same table twice: FROM t a JOIN t b
  ON a.k = b.k) — or a DERIVED
  TABLE `(SELECT ...) [AS alias]` (FROM position only, not a JOIN
  side): the inner select runs first — device pushdowns and all — and
  the outer pipeline runs the host twins over its materialized frame;
  NULL aggregates and exact object-int sums carry through. Nesting is
  unlimited.
- UNION ALL concatenates select branches by position (names from the
  first branch; per-position types must agree, text-with-text OK).
  Plain UNION additionally DEDUPES the accumulated rows at that joint
  (left-associative, NULLs equal NULLs, first occurrence kept in
  order): a UNION b UNION ALL c dedupes a+b but keeps c's duplicates.
  EXCEPT / INTERSECT join branches the same way (equal precedence,
  left-associative, SQLite's rule): the accumulated side's distinct
  rows absent from / present in the branch, first occurrence kept.
  A trailing ORDER BY/LIMIT binds to the LAST branch — wrap the union
  in a derived table to order/limit the whole.
- JOIN sides may also pair with `USING (k [, k2 ...])` (sugar for
  ON l.k = r.k AND ...) and `CROSS JOIN` takes no condition: the
  Cartesian record-id product materializes both sides by gathered
  ids (join.join_records how='cross'); WHERE/items run the same
  joined-frame host twins.
- expr: comparisons (= == != <> < <= > >=) of a column against a
  literal, BETWEEN x AND y, IN (a, b, ...) or IN (SELECT ...) — the
  inner select (one output column, its own device pushdowns) runs
  first and its distinct non-NULL values become the IN list the
  outer predicate compiles against; a SCALAR subquery may be the
  right side of any comparison (`qty > (SELECT AVG(qty) FROM t)`):
  at most one row, empty/NULL matches nothing — and may appear as a
  VALUE inside any expression, in items or WHERE arithmetic
  (`SELECT (SELECT MAX(x) FROM u) AS m`, `qty - (SELECT AVG(qty)
  FROM t)`, `WHERE q > (SELECT ...) - 2`; a NULL/empty scalar VALUE
  raises rather than silently nulling the expression) — [NOT] EXISTS
  (SELECT ...): an uncorrelated inner runs once and folds to a
  constant through the AND/OR/NOT tree (a whole-tree TRUE drops the
  WHERE, FALSE matches nothing); a correlated inner whose
  correlation is top-level equality conjuncts (one or MORE:
  `inner.a = outer.a AND inner.b = outer.b AND ...`) rewrites to the
  equivalent semi-join — single key rides `outer_col IN (SELECT
  inner_col ...)`, multiple keys compile to a composite-key
  membership leaf evaluated by shared-code factorization
  (query._in_rows_mask / sql._frame_leaf) — (inner aliases shadow
  outer names, SQL scoping); inequality and OR-nested correlation
  (`inner.b < outer.y`, `inner.a = outer.x OR ...`) evaluate a
  blocked pairwise theta semi-join per distinct outer key tuple
  (size-guarded; _exists_correlated_general) and ride the same
  membership leaves —
  LIKE 'pat' [ESCAPE 'c']
  (full SQL wildcards, matched byte-wise on device: '%' = any run
  anywhere incl. mid-pattern — greedy in-order segment matching;
  '_' = exactly one byte; ESCAPE makes the next char literal;
  no '%'/'_' -> text equality; '%' alone -> match-all); comparisons
  may also be ARITHMETIC on either side (`qty * price > 100`,
  `qty > price`), evaluated on device with the item semantics above,
  col IS [NOT] NULL (NULL = typed-parse failure; over a join also
  the absent side of an unmatched row), combined with NOT / AND / OR
  and parentheses (standard precedence). UPPER(col)/LOWER(col) wrap a
  text column for case-insensitive = != IN LIKE: the fold is
  ASCII-only (A-Z/a-z, SQL C collation) and runs ON DEVICE over the
  one gather the predicate already does, the literal folds on host.
- HAVING leaves compare agg(column), COUNT(*), or a SELECT alias of
  an aggregate (HAVING c >= 2 after COUNT(*) AS c) against numbers.

Semantics follow the underlying layer, not full SQL: rows whose column
fails its typed parse never satisfy a comparison (SQL NULL-ish), and
NOT is a pure set complement (query.py's `not`). Aggregate queries
return a SqlResult (host arrays, exact integer sums); plain selections
return a Frame. GROUP BY over a JOIN pushes down to per-side DEVICE
group-bys combined on host when the group keys are the join keys
(inner/left/right — _try_join_groupby_pushdown; EXPLAIN shows which
plan applies); otherwise aggregates reduce on host over the joined
frame (the join itself still runs on device).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from .device import resolve_device
from .utils.metrics import GLOBAL

__all__ = ["sql", "explain", "SqlResult", "SqlError"]


class SqlError(ValueError):
    """Parse or compile error for a SQL query."""


# ---------------------------------------------------------------- lexer

_TOKEN_RE = re.compile(
    r"""\s*(?:
        (?P<num>\d+(?:\.\d+)?(?:[eE][+-]?\d+)?)
      | (?P<str>'(?:[^']|'')*')
      | (?P<qid>"(?:[^"]|"")*")
      | (?P<id>[A-Za-z_][A-Za-z_0-9]*)
      | (?P<op>\|\||<=|>=|!=|<>|==|=|<|>)
      | (?P<punc>[(),.*+/%-])
    )""",
    re.VERBOSE,
)

_KEYWORDS = {
    "select", "distinct", "from", "where", "group", "by", "having",
    "order", "limit", "and", "or", "not", "between", "in", "like",
    "as", "asc", "desc", "join", "inner", "left", "right", "full",
    "outer", "semi", "anti", "cross", "on", "using", "is", "null",
    "offset", "case", "when", "then", "end", "else", "escape",
    "union", "all", "except", "intersect", "exists",
}

_AGG_FNS = {"sum", "min", "max", "count", "avg", "mean",
            "group_concat", "string_agg"}
# text functions sharing the "fold" item kind (host-applied at
# materialization, like UPPER/LOWER; WHERE-side folds stay upper/lower)
_TEXT_FNS = {"upper", "lower", "trim", "ltrim", "rtrim",
             "substr", "substring", "concat", "replace", "instr"}
# folds whose first tuple element is the column ref (rest: arguments)
_TUPLE_FOLDS = ("substr", "replace", "instr")
# pure window functions (aggregates also become windows via OVER)
_WIN_FNS = {"row_number", "rank", "dense_rank", "percent_rank",
            "cume_dist", "lag", "lead", "first_value", "last_value",
            "nth_value", "ntile"}


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip() == "":
                break
            raise SqlError(
                f"cannot tokenize SQL at: {text[pos:pos + 30]!r}"
            )
        pos = m.end()
        if m.group("num") is not None:
            out.append(("num", m.group("num")))
        elif m.group("str") is not None:
            out.append(("str", m.group("str")[1:-1].replace("''", "'")))
        elif m.group("qid") is not None:
            out.append(("name", m.group("qid")[1:-1].replace('""', '"')))
        elif m.group("id") is not None:
            word = m.group("id")
            if word.lower() in _KEYWORDS:
                out.append(("kw", word.lower()))
            else:
                out.append(("name", word))
        elif m.group("op") is not None:
            op = m.group("op")
            out.append(("op", {"=": "==", "<>": "!="}.get(op, op)))
        else:
            out.append(("punc", m.group("punc")))
    out.append(("end", ""))
    return out


def _num(text: str):
    try:
        return int(text)
    except ValueError:
        return float(text)


# --------------------------------------------------------------- parser


class _Item:
    """One SELECT item: a column, an aggregate call, or *."""

    def __init__(self, kind, col=None, fn=None, alias=None,
                 distinct=False):
        self.kind = kind        # "star" | "col" | "agg"
        self.col = col
        self.fn = fn            # sum|min|max|count|mean (avg -> mean)
        self.alias = alias
        self.distinct = distinct   # COUNT(DISTINCT col)

    def default_name(self) -> str:
        if self.kind == "col":
            return self.col
        if self.kind == "coalesce":
            return "coalesce"
        if self.kind == "case":
            return "case"
        if self.kind == "expr":
            return str(self.expr)
        if self.kind == "fold":
            if self.fn == "concat":
                return "concat"
            if self.fn in _TUPLE_FOLDS:
                return f"{self.fn.upper()}({self.col[0]})"
            return f"{self.fn.upper()}({self.col})"
        if self.kind == "window":
            if self.col is None:
                return self.fn
            return f"{self.fn}_{self.col}"
        if self.fn == "count" and self.col is None:
            return "count"
        if self.distinct:
            return f"count_distinct_{self.col}"
        return f"{self.fn}_{self.col}"

    def name(self) -> str:
        return self.alias or self.default_name()


class _Union:
    """Compound select: UNION [ALL] / EXCEPT / INTERSECT branches,
    matched by position, output names from the FIRST branch. ops[i]
    joins branch i+1 onto the accumulated result — left-associative
    with equal precedence (SQLite's rule): "all" concatenates,
    "distinct" (plain UNION) concatenates then dedupes, "except" /
    "intersect" keep the accumulated side's distinct rows absent
    from / present in the branch."""

    def __init__(self, branches, ops):
        self.branches = branches
        self.ops = ops  # len(branches) - 1 entries of "all"/"distinct"


class _InSubquery:
    """Placeholder value of a `col IN (SELECT ...)` leaf — or, with
    scalar=True, of a `col op (SELECT ...)` comparison. The inner
    select (one output column) runs at dispatch time — device
    pushdowns and all — and its values replace this node, so the leaf
    compiles like any literal: IN gets the distinct non-NULL values;
    a scalar comparison needs at most ONE row (empty = SQL NULL,
    matching nothing; more than one raises)."""

    def __init__(self, ast, scalar: bool = False):
        self.ast = ast
        self.scalar = scalar

    def __repr__(self) -> str:
        return "(SELECT ...)" if self.scalar else "IN (SELECT ...)"


class _Ast:
    def __init__(self):
        self.distinct = False
        self.items: List[_Item] = []
        self.table = None                 # (kind, value): name | path
        self.table_alias: Optional[str] = None
        self.join_table = None
        self.join_alias: Optional[str] = None
        self.join_how = "inner"
        self.join_on: List[Tuple[str, str]] = []   # (left col, right col)
        self.where = None
        self.group_by: List[str] = []
        self.having = None
        self.order_by: List[Tuple[object, bool]] = []  # (_Item, desc)
        self.limit: Optional[int] = None
        self.offset: int = 0


class _Parser:
    def __init__(self, text: str):
        self.toks = _tokenize(text)
        self.i = 0

    # -- token helpers
    def peek(self, k: int = 0):
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self):
        t = self.toks[self.i]
        self.i = min(self.i + 1, len(self.toks) - 1)
        return t

    def accept(self, kind, value=None):
        k, v = self.peek()
        if k == kind and (value is None or v == value):
            return self.next()
        return None

    def expect(self, kind, value=None):
        t = self.accept(kind, value)
        if t is None:
            k, v = self.peek()
            want = value if value is not None else kind
            raise SqlError(f"expected {want!r}, got {v!r}")
        return t

    # -- grammar
    def parse(self):
        ctes = self._with_clause()
        ast = self._union()
        self.expect("end")
        if ctes:
            _inject_ctes(ast, ctes)
        return ast

    def _with_clause(self):
        """WITH name AS ( select ) [, name2 AS ( select2 )] ... —
        common table expressions. Each CTE body may reference EARLIER
        CTEs; references inject as derived tables (every reference
        re-executes the body; WITH RECURSIVE raises). Returns
        {name: sub-ast}, empty when there is no WITH."""
        if not (self.peek()[0] == "name"
                and self.peek()[1].lower() == "with"):
            return {}
        self.next()
        if self.peek()[0] == "name" \
                and self.peek()[1].lower() == "recursive":
            raise SqlError("WITH RECURSIVE is not supported")
        ctes: Dict[str, object] = {}
        while True:
            name = self.expect("name")[1]
            if name in ctes:
                raise SqlError(f"duplicate CTE name {name!r}")
            self.expect("kw", "as")
            self.expect("punc", "(")
            sub = self._union()
            self.expect("punc", ")")
            _inject_ctes(sub, ctes)  # earlier CTEs visible to later
            if _refs_table(sub, name):
                raise SqlError(
                    f"CTE {name!r} references itself (WITH RECURSIVE "
                    "is not supported)")
            ctes[name] = sub
            if not self.accept("punc", ","):
                break
        return ctes

    def _union(self):
        """select (UNION [ALL] select)* — rows concatenate by
        position; plain UNION dedupes the accumulated rows at that
        joint (left-associative). A trailing ORDER BY/LIMIT parses
        into the LAST branch (wrap the union in a derived table to
        order/limit the whole)."""
        first = self._select()
        branches, ops = [first], []
        while True:
            if self.accept("kw", "union"):
                ops.append("all" if self.accept("kw", "all")
                           else "distinct")
            elif self.accept("kw", "except"):
                ops.append("except")
            elif self.accept("kw", "intersect"):
                ops.append("intersect")
            else:
                break
            branches.append(self._select())
        if len(branches) == 1:
            return first
        return _Union(branches, ops)

    def _select(self) -> _Ast:
        ast = _Ast()
        self.expect("kw", "select")
        if self.accept("kw", "distinct"):
            ast.distinct = True
        ast.items = self._select_items()
        self.expect("kw", "from")
        ast.table = self._table()
        ast.table_alias = self._table_alias(ast.table)
        how = self._join_how()
        if how is not None:
            ast.join_how = how
            ast.join_table = self._table()
            ast.join_alias = self._table_alias(ast.join_table)
            if how == "cross":
                pass  # Cartesian product: no ON / USING clause
            elif self.accept("kw", "using"):
                # USING (k [, k2 ...]): sugar for ON l.k = r.k AND ...
                self.expect("punc", "(")
                cols = [self.expect("name")[1]]
                while self.accept("punc", ","):
                    cols.append(self.expect("name")[1])
                self.expect("punc", ")")
                ast.join_on = [(c, c) for c in cols]
            else:
                self.expect("kw", "on")
                ast.join_on = self._on_pairs()
        if self.accept("kw", "where"):
            ast.where = self._expr(having=False)
        if self.accept("kw", "group"):
            self.expect("kw", "by")
            ast.group_by = self._group_list()
        if self.accept("kw", "having"):
            # HAVING may reference SELECT aliases (HAVING c >= 2 after
            # COUNT(*) AS c — SQLite/DuckDB both accept it); expose the
            # parsed items to _having_leaf, save/restored because
            # derived tables recurse through this same parser
            prev_items = getattr(self, "_cur_items", None)
            self._cur_items = ast.items
            try:
                ast.having = self._expr(having=True)
            finally:
                self._cur_items = prev_items
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            ast.order_by = self._order_items()
        if self.accept("kw", "limit"):
            ast.limit = self._int_literal("LIMIT")
            if self.accept("kw", "offset"):
                ast.offset = self._int_literal("OFFSET")
        _resolve_ordinals(ast)
        return _rewrite_alias_group_by(ast)

    def _number(self):
        """Numeric literal with optional unary minus (numbers tokenize
        unsigned so `a-5` means subtraction, not the literal -5)."""
        neg = bool(self.accept("punc", "-"))
        v = _num(self.expect("num")[1])
        return -v if neg else v

    def _int_literal(self, what: str) -> int:
        v = self._number()
        if not isinstance(v, int):
            raise SqlError(f"{what} must be an integer, got {v!r}")
        if v < 0:
            raise SqlError(f"{what} must be non-negative, got {v}")
        return v

    def _select_items(self) -> List[_Item]:
        items = []
        while True:
            items.append(self._item())
            if not self.accept("punc", ","):
                return items

    def _item(self) -> _Item:
        if self.accept("punc", "*"):
            return _Item("star")
        if self.peek()[0] == "str" and self.peek(1) == ("op", "||"):
            it = None  # leading literal: 'x' || col
            parts = [("lit", self.next()[1])]
        else:
            it = self._item_core()
            parts = None
        if it is not None and self._at_over():
            # agg(col) OVER (...) / window fn: a window item
            if it.kind == "window":
                pass  # _item_core already consumed its OVER
            elif it.kind != "agg" or it.distinct:
                raise SqlError(
                    "OVER follows an aggregate call or a window "
                    "function (ROW_NUMBER/RANK/DENSE_RANK/LAG/LEAD)"
                )
            else:
                w = _Item("window", col=it.col, fn=it.fn)
                w.part, w.worder, w.frame = self._over_clause()
                w.offset = 0
                it = w
        if self.peek() == ("op", "||"):
            # a || b || 'x' desugars to CONCAT(a, b, 'x')
            parts = parts or [self._as_concat_part(it)]
            while self.accept("op", "||"):
                parts.append(self._concat_part())
            it = self._make_concat(parts)
        if self.accept("kw", "as"):
            it.alias = self.expect("name")[1]
        return it

    @staticmethod
    def _as_concat_part(it: _Item):
        if it.kind == "col":
            return ("col", it.col)
        if it.kind == "fold":
            return ("item", it)
        raise SqlError(
            "|| concatenates text columns, string literals and text "
            f"functions; {it.name()!r} is not one"
        )

    def _case_value(self):
        k, v = self.peek()
        if k == "str":
            self.next()
            return ("lit", v)
        tree = self._vexpr()
        if tree[0] == "col":
            return ("col", tree[1])
        if tree[0] == "lit":
            return ("lit", tree[1])
        from .query import VExpr

        return ("expr", VExpr(tree))

    def _item_core(self) -> _Item:
        k, v = self.peek()
        if k == "kw" and v == "case":
            self.next()
            branches = []
            while self.accept("kw", "when"):
                cond = self._expr(having=False)
                self.expect("kw", "then")
                branches.append((cond, self._case_value()))
            if not branches:
                raise SqlError("CASE needs at least one WHEN branch")
            else_v = (self._case_value()
                      if self.accept("kw", "else") else None)
            self.expect("kw", "end")
            it = _Item("case")
            it.branches = branches
            it.else_value = else_v
            return it
        if k == "name" and v.lower() in _TEXT_FNS \
                and self.peek(1) == ("punc", "("):
            # text-function item: SELECT UPPER(col), SUBSTR(col,i,n),
            # TRIM(col), CONCAT(a, '-', b) — projection (the
            # WHERE-side fold is parsed separately in _leaf)
            return self._textfn_item()
        if k == "name" and v.lower() in _WIN_FNS \
                and self.peek(1) == ("punc", "("):
            return self._window_fn_item()
        if k == "name" and v.lower() == "nullif" \
                and self.peek(1) == ("punc", "("):
            # NULLIF(a, b) = CASE WHEN a != b THEN a END: value is
            # column a, NULL where a equals b (b: column or literal)
            self.next()
            self.expect("punc", "(")
            a = self._colref()
            self.expect("punc", ",")
            bk, bv = self.peek()
            if bk == "str":
                self.next()
                cond = (a, "!=", bv)
            elif bk == "num" or (bk, bv) == ("punc", "-"):
                cond = (a, "!=", self._number())
            else:
                from .query import VExpr

                b = self._colref()
                cond = (VExpr(("col", a)), "!=", VExpr(("col", b)))
            self.expect("punc", ")")
            it = _Item("case")
            it.branches = [(cond, ("col", a))]
            it.else_value = None
            it.alias = "nullif"
            return it
        if k == "name" and v.lower() in ("coalesce", "ifnull") \
                and self.peek(1) == ("punc", "("):
            fn = self.next()[1].lower()
            self.expect("punc", "(")
            cols = [self._colref()]
            while self.accept("punc", ","):
                cols.append(self._colref())
            self.expect("punc", ")")
            if fn == "ifnull" and len(cols) != 2:
                raise SqlError(
                    f"IFNULL takes exactly two columns, got {len(cols)}"
                )
            if len(cols) < 2:
                raise SqlError("COALESCE needs at least two columns")
            return _Item("coalesce", col=tuple(cols))
        if k == "name" and v.lower() in _AGG_FNS \
                and self.peek(1) == ("punc", "("):
            fn = self.next()[1].lower()
            fn = "mean" if fn == "avg" else fn
            self.expect("punc", "(")
            dis = bool(self.accept("kw", "distinct"))
            if dis and fn != "count":
                raise SqlError(
                    "DISTINCT inside an aggregate is COUNT-only "
                    f"({fn.upper()}(DISTINCT ...) is not supported)"
                )
            if self.accept("punc", "*"):
                if fn != "count" or dis:
                    raise SqlError(f"{fn}(*) is not a thing; name a column")
                col = None
            else:
                tree = self._vexpr()
                if dis and tree[0] != "col":
                    raise SqlError(
                        "COUNT(DISTINCT ...) takes a single column"
                    )
                if tree[0] == "col":
                    col = tree[1]
                else:
                    # aggregate over an arithmetic expression: the
                    # VExpr evaluates on device inside the group-by /
                    # stats machinery
                    from .query import VExpr

                    col = VExpr(tree)
            sep = ","
            if fn in ("group_concat", "string_agg") \
                    and self.accept("punc", ","):
                if self.peek()[0] != "str":
                    raise SqlError(
                        f"{fn.upper()} separator must be a string "
                        "literal")
                sep = self.next()[1]
            self.expect("punc", ")")
            if fn in ("group_concat", "string_agg"):
                # STRING_AGG is the Postgres spelling of the same
                # aggregate; one canonical name downstream
                if not isinstance(col, str):
                    raise SqlError(
                        f"{fn.upper()} takes a plain column")
                it = _Item("agg", col=col, fn="group_concat",
                           distinct=dis)
                it.sep = sep
                return it
            return _Item("agg", col=col, fn=fn, distinct=dis)
        tree = self._vexpr()
        if tree[0] == "col":
            return _Item("col", col=tree[1])
        from .query import VExpr

        it = _Item("expr")
        it.expr = VExpr(tree)
        return it

    def _at_over(self) -> bool:
        k, v = self.peek()
        return (k == "name" and v.lower() == "over"
                and self.peek(1) == ("punc", "("))

    def _over_clause(self):
        """OVER ( [PARTITION BY cols] [ORDER BY col [ASC|DESC], ...]
        [ROWS|RANGE frame] ) — returns (partition cols,
        [(order col, desc)], frame).

        frame is None (SQL's default RANGE UNBOUNDED PRECEDING with
        peer sharing) or ("rows", lo, hi) with lo/hi row offsets
        relative to the current row (None = unbounded on that side):
        ROWS BETWEEN <bound> AND <bound>, or the single-bound shorthand
        ROWS <bound> (= BETWEEN <bound> AND CURRENT ROW). RANGE is
        accepted for its two spellable-by-default forms (UNBOUNDED
        PRECEDING..CURRENT ROW = the default; UNBOUNDED..UNBOUNDED =
        whole partition, returned as ("rows", None, None) since they
        coincide); value-offset RANGE frames raise."""
        self.next()  # 'over'
        self.expect("punc", "(")
        part, worder, frame = [], [], None
        if self.peek()[0] == "name" \
                and self.peek()[1].lower() == "partition":
            self.next()
            self.expect("kw", "by")
            part = self._name_list()
        if self.accept("kw", "order"):
            self.expect("kw", "by")
            while True:
                c = self._colref()
                worder.append((c, self._direction()))
                if not self.accept("punc", ","):
                    break
        kind = None
        if self.peek()[0] == "name" \
                and self.peek()[1].lower() in ("rows", "range"):
            kind = self.next()[1].lower()
            if not worder:
                raise SqlError(
                    f"a {kind.upper()} frame needs ORDER BY in OVER")

            def _bound(is_hi):
                k, v = self.peek()
                word = (v.lower() if k in ("name", "kw") else "")
                if word == "unbounded":
                    self.next()
                    d = self.next()[1].lower()
                    if d == "preceding":
                        return ("unb", -1)
                    if d == "following":
                        return ("unb", 1)
                    raise SqlError(
                        "UNBOUNDED must be PRECEDING or FOLLOWING")
                if word == "current":
                    self.next()
                    nxt = self.next()[1].lower()
                    if nxt != "row":
                        raise SqlError("expected CURRENT ROW")
                    return ("off", 0)
                off = self._number()
                if not isinstance(off, int) or off < 0:
                    raise SqlError(
                        f"frame offset must be a non-negative integer, "
                        f"got {off!r}")
                d = self.next()[1].lower()
                if d == "preceding":
                    return ("off", -off)
                if d == "following":
                    return ("off", off)
                raise SqlError(
                    "frame offset must be PRECEDING or FOLLOWING")

            if self.accept("kw", "between"):
                b1 = _bound(False)
                self.expect("kw", "and")
                b2 = _bound(True)
            else:
                b1 = _bound(False)
                b2 = ("off", 0)  # shorthand: .. AND CURRENT ROW
            lo = None if b1 == ("unb", -1) else b1[1]
            hi = None if b2 == ("unb", 1) else b2[1]
            if b1 == ("unb", 1) or b2 == ("unb", -1):
                raise SqlError(
                    "frame bounds reversed (UNBOUNDED FOLLOWING can "
                    "only end a frame)")
            if kind == "range":
                if (lo, hi) not in ((None, 0), (None, None)):
                    raise SqlError(
                        "RANGE frames support only UNBOUNDED "
                        "PRECEDING..CURRENT ROW (the default) or "
                        "UNBOUNDED..UNBOUNDED FOLLOWING; use ROWS for "
                        "offset frames")
                # UNBOUNDED..CURRENT ROW *with peer sharing* IS the
                # default — represent as no frame; UNBOUNDED..UNBOUNDED
                # = whole partition, same under ROWS or RANGE
                frame = None if (lo, hi) == (None, 0) \
                    else ("rows", None, None)
            else:
                if lo is not None and hi is not None and lo > hi:
                    raise SqlError(
                        f"empty ROWS frame: {lo} PRECEDING/FOLLOWING "
                        f"starts after {hi}")
                frame = ("rows", lo, hi)
        self.expect("punc", ")")
        return part, worder, frame

    def _window_fn_item(self) -> _Item:
        """ROW_NUMBER()/RANK()/DENSE_RANK(), LAG/LEAD(col [, n]),
        FIRST_VALUE/LAST_VALUE(col), NTH_VALUE(col, n), NTILE(n) —
        each requiring an OVER clause."""
        fn = self.next()[1].lower()
        self.expect("punc", "(")
        col, off = None, 1
        if fn in ("lag", "lead", "first_value", "last_value",
                  "nth_value"):
            col = self._colref()
            if fn in ("lag", "lead") and self.accept("punc", ","):
                off = self._number()
                if not isinstance(off, int) or off < 1:
                    raise SqlError(
                        f"{fn.upper()} offset must be >= 1, got {off!r}")
            if fn == "nth_value":
                self.expect("punc", ",")
                off = self._number()
                if not isinstance(off, int) or off < 1:
                    raise SqlError(
                        f"NTH_VALUE position must be >= 1, got {off!r}")
        elif fn == "ntile":
            off = self._number()
            if not isinstance(off, int) or off < 1:
                raise SqlError(
                    f"NTILE bucket count must be >= 1, got {off!r}")
        self.expect("punc", ")")
        if not self._at_over():
            raise SqlError(f"{fn.upper()}() needs OVER (...)")
        it = _Item("window", col=col, fn=fn)
        it.part, it.worder, it.frame = self._over_clause()
        it.offset = off
        if it.frame is not None and fn not in (
                "first_value", "last_value", "nth_value"):
            raise SqlError(
                f"{fn.upper()}() does not take a ROWS/RANGE frame "
                "(frames apply to aggregates and FIRST/LAST/NTH_VALUE)")
        if fn in ("rank", "dense_rank", "percent_rank", "cume_dist",
                  "ntile") and not it.worder:
            raise SqlError(f"{fn.upper()}() needs ORDER BY in OVER")
        return it

    def _textfn_item(self) -> _Item:
        """Text functions (the shared "fold" item kind): UPPER/LOWER,
        TRIM/LTRIM/RTRIM (ASCII-space strip), SUBSTR[ING](col, start
        [, len]) with SQL's 1-based start, CONCAT(part, part, ...)
        where a part is a column ref, a 'string literal', or a nested
        text-function call."""
        fn = self.next()[1].lower()
        self.expect("punc", "(")
        if fn in ("upper", "lower", "trim", "ltrim", "rtrim"):
            col = self._colref()
            self.expect("punc", ")")
            return _Item("fold", col=col, fn=fn)
        if fn in ("substr", "substring"):
            col = self._colref()
            self.expect("punc", ",")
            start = self._number()
            if not isinstance(start, int) or start < 1:
                raise SqlError(
                    f"SUBSTR start is 1-based (>= 1), got {start!r}")
            length = None
            if self.accept("punc", ","):
                length = self._number()
                if not isinstance(length, int) or length < 0:
                    raise SqlError(
                        f"SUBSTR length must be >= 0, got {length!r}")
            self.expect("punc", ")")
            return _Item("fold", col=(col, start, length), fn="substr")
        if fn == "replace":
            col = self._colref()
            self.expect("punc", ",")
            frm = self.expect("str")[1]
            self.expect("punc", ",")
            to = self.expect("str")[1]
            self.expect("punc", ")")
            return _Item("fold", col=(col, frm, to), fn="replace")
        if fn == "instr":
            col = self._colref()
            self.expect("punc", ",")
            sub = self.expect("str")[1]
            self.expect("punc", ")")
            return _Item("fold", col=(col, sub), fn="instr")
        # CONCAT(part, part, ...)
        parts = [self._concat_part()]
        while self.accept("punc", ","):
            parts.append(self._concat_part())
        self.expect("punc", ")")
        return self._make_concat(parts)

    def _concat_part(self):
        """One CONCAT/|| operand: ("lit", s) | ("col", name) |
        ("item", nested fold _Item)."""
        k, v = self.peek()
        if k == "str":
            self.next()
            return ("lit", v)
        if k == "name" and v.lower() in _TEXT_FNS \
                and self.peek(1) == ("punc", "("):
            return ("item", self._textfn_item())
        return ("col", self._colref())

    @staticmethod
    def _make_concat(parts) -> _Item:
        flat = []
        for p in parts:
            if p[0] == "item" and p[1].fn == "instr":
                raise SqlError(
                    "INSTR returns an integer — not usable inside "
                    "CONCAT/||"
                )
            # splice nested concats (a || b || c parses pairwise)
            if p[0] == "item" and p[1].fn == "concat":
                flat.extend(p[1].col)
            else:
                flat.append(p)
        if not any(p[0] != "lit" for p in flat):
            raise SqlError("CONCAT needs at least one column operand")
        return _Item("fold", col=tuple(flat), fn="concat")

    def _colref(self) -> str:
        name = self.expect("name")[1]
        if self.accept("punc", "."):
            # qualified a.col: keep "alias.col" — the executor resolves
            # it against the join sides
            name = f"{name}.{self.expect('name')[1]}"
        return name

    # -- value expressions (arithmetic over columns/literals)
    def _vexpr(self):
        t = self._vterm()
        while True:
            if self.accept("punc", "+"):
                t = ("+", t, self._vterm())
            elif self.accept("punc", "-"):
                t = ("-", t, self._vterm())
            else:
                return t

    def _vterm(self):
        t = self._vfactor()
        while True:
            if self.accept("punc", "*"):
                t = ("*", t, self._vfactor())
            elif self.accept("punc", "/"):
                t = ("/", t, self._vfactor())
            elif self.accept("punc", "%"):
                t = ("%", t, self._vfactor())
            else:
                return t

    def _vfactor(self):
        if self.accept("punc", "-"):
            f = self._vfactor()
            # fold a negated literal so `qty > -5` keeps the legacy
            # (col, op, number) leaf shape
            return ("lit", -f[1]) if f[0] == "lit" else ("neg", f)
        if self.peek() == ("punc", "(") \
                and self.peek(1) == ("kw", "select"):
            # scalar subquery as a VALUE: SELECT (SELECT MAX(x) ...),
            # qty - (SELECT AVG(qty) ...) — resolved to a literal at
            # execution (_resolve_in_subqueries), like scalar
            # comparisons
            self.next()
            sub = self._union()
            self.expect("punc", ")")
            return ("ssub", _InSubquery(sub, scalar=True))
        if self.accept("punc", "("):
            e = self._vexpr()
            self.expect("punc", ")")
            return e
        if self.peek()[0] == "num":
            return ("lit", _num(self.next()[1]))
        k, v = self.peek()
        if k == "name" and v.lower() in ("length", "char_length") \
                and self.peek(1) == ("punc", "("):
            self.next()
            self.expect("punc", "(")
            col = self._colref()
            self.expect("punc", ")")
            return ("len", col)
        if k == "name" and v.lower() in ("abs", "floor", "ceil",
                                         "ceiling") \
                and self.peek(1) == ("punc", "("):
            fn = self.next()[1].lower()
            fn = "ceil" if fn == "ceiling" else fn
            self.expect("punc", "(")
            e = self._vexpr()
            self.expect("punc", ")")
            return (fn, e)
        if k == "name" and v.lower() == "round" \
                and self.peek(1) == ("punc", "("):
            self.next()
            self.expect("punc", "(")
            e = self._vexpr()
            d = 0
            if self.accept("punc", ","):
                neg = bool(self.accept("punc", "-"))
                dv = _num(self.expect("num")[1])
                if not isinstance(dv, int):
                    raise SqlError(
                        f"ROUND's second argument is an integer "
                        f"number of decimal places, got {dv!r}")
                d = -dv if neg else dv
            self.expect("punc", ")")
            return ("round", e, ("lit", d))
        if k == "name" and v.lower() == "cast" \
                and self.peek(1) == ("punc", "("):
            self.next()
            self.expect("punc", "(")
            e = self._vexpr()
            self.expect("kw", "as")
            ty = self.expect("name")[1].lower()
            if ty in ("int", "integer", "bigint", "smallint"):
                ty = "int"
            elif ty in ("float", "real", "double"):
                ty = "float"
            else:
                raise SqlError(
                    f"CAST target must be INTEGER or FLOAT/REAL, "
                    f"got {ty!r}")
            self.expect("punc", ")")
            return ("cast", e, ty)
        if k == "name" and v.lower() == "mod" \
                and self.peek(1) == ("punc", "("):
            self.next()
            self.expect("punc", "(")
            a = self._vexpr()
            self.expect("punc", ",")
            b = self._vexpr()
            self.expect("punc", ")")
            return ("%", a, b)
        return ("col", self._colref())

    def _table(self):
        if self.peek() == ("punc", "(") \
                and self.peek(1) == ("kw", "select"):
            # derived table: FROM (SELECT ... [UNION ALL ...]) [AS] a
            self.next()
            sub = self._union()
            self.expect("punc", ")")
            alias = None
            if self.accept("kw", "as"):
                alias = self.expect("name")[1]
            elif self.peek()[0] == "name":
                alias = self.next()[1]
            return ("subquery", (sub, alias))
        k, v = self.next()
        if k == "str":
            return ("path", v)
        if k == "name":
            return ("name", v)
        raise SqlError(f"expected a table name or 'path', got {v!r}")

    def _table_alias(self, tbl) -> Optional[str]:
        """Optional `[AS] alias` after a base table or quoted path —
        enables self-joins (FROM t a JOIN t b ON a.k = b.k) and
        qualified refs over paths. Derived tables carry their own
        alias (parsed in _table); keywords never read as an alias
        (they tokenize as kw, not name)."""
        if tbl[0] == "subquery":
            return tbl[1][1]
        if self.accept("kw", "as"):
            return self.expect("name")[1]
        if self.peek()[0] == "name":
            return self.next()[1]
        return None

    def _join_how(self) -> Optional[str]:
        for kw, how in (("inner", "inner"), ("left", "left"),
                        ("right", "right"), ("full", "outer"),
                        ("semi", "semi"), ("anti", "anti"),
                        ("cross", "cross")):
            if self.peek() == ("kw", kw):
                self.next()
                self.accept("kw", "outer")
                self.expect("kw", "join")
                return how
        if self.accept("kw", "join"):
            return "inner"
        return None

    def _on_pairs(self) -> List[Tuple[str, str]]:
        pairs = []
        while True:
            a = self._colref()
            self.expect("op", "==")
            b = self._colref()
            pairs.append((a, b))
            if not self.accept("kw", "and"):
                return pairs

    def _name_list(self) -> List[str]:
        out = [self._colref()]
        while self.accept("punc", ","):
            out.append(self._colref())
        return out

    def _group_list(self) -> List:
        """GROUP BY accepts column refs AND 1-based ordinals (GROUP
        BY 1 = the first SELECT item, SQLite/Postgres semantics);
        ordinals resolve post-parse (_resolve_ordinals)."""
        def one():
            if self.peek()[0] == "num":
                v = _num(self.next()[1])
                if not isinstance(v, int):
                    raise SqlError(
                        f"GROUP BY ordinal must be an integer, got {v!r}")
                return v
            return self._colref()

        out = [one()]
        while self.accept("punc", ","):
            out.append(one())
        return out

    def _nulls_modifier(self) -> bool:
        """[NULLS FIRST|LAST] -> True for an explicit NULLS FIRST.
        The layer's default is NULLs LAST in BOTH directions
        (parse-failures sort last; every sort path — device, host,
        windows — shares it); NULLS FIRST flips only the placement of
        the NULL block, never the key order."""
        if not (self.peek()[0] == "name"
                and self.peek()[1].lower() == "nulls"):
            return False
        self.next()
        word = self.next()[1].lower()
        if word == "first":
            return True
        if word != "last":
            raise SqlError("expected NULLS FIRST or NULLS LAST")
        return False

    def _direction(self):
        """[ASC|DESC] [NULLS FIRST|LAST] -> bool-like direction (a
        query.SortDir when NULLS FIRST rides along)."""
        from .query import SortDir

        desc = bool(self.accept("kw", "desc"))
        if not desc:
            self.accept("kw", "asc")
        return SortDir(desc, nulls_first=True) if self._nulls_modifier() \
            else desc

    def _order_items(self):
        out = []
        while True:
            it = self._item_core()
            out.append((it, self._direction()))
            if not self.accept("punc", ","):
                return out

    # -- boolean expressions (OR < AND < NOT < primary)
    def _expr(self, having: bool):
        terms = [self._and_term(having)]
        while self.accept("kw", "or"):
            terms.append(self._and_term(having))
        return terms[0] if len(terms) == 1 else ("or", terms)

    def _and_term(self, having: bool):
        terms = [self._not_term(having)]
        while self.accept("kw", "and"):
            terms.append(self._not_term(having))
        return terms[0] if len(terms) == 1 else ("and", terms)

    def _not_term(self, having: bool):
        if self.accept("kw", "not"):
            return ("not", self._not_term(having))
        if self.peek() == ("punc", "("):
            # "(" is ambiguous: boolean grouping `(a > 1 OR ...)` vs an
            # arithmetic factor `(a + 1) > 2` — try the boolean parse
            # and backtrack into a leaf when it doesn't close
            save = self.i
            try:
                self.next()
                e = self._expr(having)
                self.expect("punc", ")")
                return e
            except SqlError:
                self.i = save
        return self._having_leaf() if having else self._leaf()

    def _literal(self):
        if self.peek() in (("punc", "-"),) or self.peek()[0] == "num":
            return self._number()
        k, v = self.next()
        if k == "str":
            return v
        raise SqlError(f"expected a literal, got {v!r}")

    def _leaf(self):
        k, v = self.peek()
        if (k, v) == ("kw", "exists"):
            # [NOT] EXISTS (SELECT ...): resolved before execution —
            # uncorrelated inners fold to a constant, single-equality
            # correlated inners rewrite to IN (see _resolve_exists)
            self.next()
            self.expect("punc", "(")
            sub = self._union()
            self.expect("punc", ")")
            return ("exists", _InSubquery(sub))
        if k == "name" and v.lower() in ("upper", "lower") \
                and self.peek(1) == ("punc", "("):
            # case-folded text predicate: UPPER(col) = 'X' / LIKE / IN
            from .query import TextFold

            fn = self.next()[1].lower()
            self.expect("punc", "(")
            col = self._colref()
            self.expect("punc", ")")
            key = TextFold(fn, col)
            negate = bool(self.accept("kw", "not"))
            if self.accept("kw", "in"):
                leaf = (key, "in", self._in_list())
            elif self.accept("kw", "like"):
                pat = self.expect("str")[1]
                esc = None
                if self.accept("kw", "escape"):
                    esc = self.expect("str")[1]
                    if len(esc) != 1:
                        raise SqlError(
                            f"ESCAPE needs a single character, got {esc!r}")
                c, op, val = _like_leaf("_", pat, esc)
                leaf = (key, op, val)
            else:
                if negate:
                    raise SqlError(
                        "NOT after UPPER()/LOWER() must be followed by "
                        "IN/LIKE"
                    )
                op = self.expect("op")[1]
                if op not in ("==", "!="):
                    raise SqlError(
                        f"UPPER()/LOWER() compares with =, !=, IN or "
                        f"LIKE, not {op!r}"
                    )
                kk, vv = self.next()
                if kk not in ("str", "num"):
                    raise SqlError(
                        f"UPPER()/LOWER() compares against a literal, "
                        f"got {vv!r}"
                    )
                leaf = (key, op, vv if kk == "str" else _num(vv))
            return ("not", leaf) if negate else leaf
        lhs = self._vexpr()
        if lhs[0] != "col":
            # arithmetic comparison: expr op expr (device-evaluated)
            from .query import VExpr

            op = self.expect("op")[1]
            if self.peek()[0] == "str":
                raise SqlError(
                    "arithmetic expressions compare against numbers, "
                    f"got {self.peek()[1]!r}"
                )
            rhs = self._vexpr()
            return (VExpr(lhs), op, VExpr(rhs))
        col = lhs[1]
        if self.accept("kw", "is"):
            neg = bool(self.accept("kw", "not"))
            self.expect("kw", "null")
            return (col, "notnull" if neg else "isnull", None)
        negate = bool(self.accept("kw", "not"))
        if self.accept("kw", "between"):
            lo = self._literal()
            self.expect("kw", "and")
            hi = self._literal()
            leaf = (col, "between", (lo, hi))
        elif self.accept("kw", "in"):
            leaf = (col, "in", self._in_list())
        elif self.accept("kw", "like"):
            pat = self.expect("str")[1]
            esc = None
            if self.accept("kw", "escape"):
                esc = self.expect("str")[1]
                if len(esc) != 1:
                    raise SqlError(
                        f"ESCAPE needs a single character, got {esc!r}")
            leaf = _like_leaf(col, pat, esc)
        else:
            if negate:
                raise SqlError(
                    "NOT here must be followed by BETWEEN/IN/LIKE"
                )
            op = self.expect("op")[1]
            if self.peek()[0] == "str":
                leaf = (col, op, self.next()[1])
            else:
                # _vexpr also parses scalar subqueries as values
                # (("ssub", _InSubquery)), so `col > (SELECT ...) - 2`
                # composes; a BARE scalar subquery keeps the legacy
                # (col, op, _InSubquery) leaf shape
                rhs = self._vexpr()
                if rhs[0] == "lit":
                    leaf = (col, op, rhs[1])
                elif rhs[0] == "ssub":
                    leaf = (col, op, rhs[1])
                else:
                    # column-vs-column / column-vs-expression compares
                    # evaluate as arithmetic on device
                    from .query import VExpr

                    leaf = (VExpr(lhs), op, VExpr(rhs))
        return ("not", leaf) if negate else leaf

    def _in_list(self):
        """After IN: a parenthesized literal list, or a scalar
        SUBQUERY `IN (SELECT ...)` — resolved to its distinct non-NULL
        values at execution, before the WHERE pushdown compiles."""
        self.expect("punc", "(")
        if self.peek() == ("kw", "select"):
            sub = self._union()
            self.expect("punc", ")")
            return _InSubquery(sub)
        vals = [self._literal()]
        while self.accept("punc", ","):
            vals.append(self._literal())
        self.expect("punc", ")")
        return vals

    def _having_leaf(self):
        it = self._item_core()
        if it.kind == "col":
            # a bare name may be a SELECT alias of an aggregate:
            # HAVING resolves it to the aliased aggregate itself, the
            # way ORDER BY already resolves aliases
            aliased = next(
                (s for s in getattr(self, "_cur_items", None) or []
                 if s.kind == "agg" and s.alias == it.col), None)
            if aliased is not None:
                it = aliased
        if it.kind != "agg":
            raise SqlError(
                "HAVING conditions compare aggregates (or SELECT "
                "aliases of aggregates), e.g. COUNT(*) >= 10, "
                "SUM(qty) > 0, or c >= 2 after COUNT(*) AS c"
            )
        if it.fn == "group_concat":
            raise SqlError(
                "HAVING cannot compare GROUP_CONCAT (a text "
                "aggregate) against numbers"
            )
        op = self.expect("op")[1]
        if self.peek()[0] != "num" and self.peek() != ("punc", "-"):
            raise SqlError(
                f"HAVING compares against numbers, got {self.peek()[1]!r}"
            )
        target = "count" if (it.fn == "count" and it.col is None) \
            else f"{it.col}.{it.fn}"
        return (target, op, self._number())


def _like_leaf(col: str, pat: str, esc=None):
    if esc is not None:
        # escapes change which %/_ are wildcards: the (pattern, escape)
        # pair travels whole to query._compile_like
        return (col, "like", (pat, esc))
    core = pat.strip("%")
    if "%" in core or "_" in core:
        # mid-pattern `%` runs/`_` wildcards compile to device matchers
        # (query._like_general_mask / _wild_mask); the whole pattern
        # travels as one leaf
        return (col, "like", pat)
    if pat == "":
        return (col, "==", "")
    if core == "":
        # '%' (or '%%'): match-all — an empty-needle startswith
        # matches every decoded field
        return (col, "startswith", "")
    if pat.startswith("%") and pat.endswith("%"):
        return (col, "contains", core)
    if pat.endswith("%"):
        return (col, "startswith", core)
    if pat.startswith("%"):
        return (col, "endswith", core)
    return (col, "==", pat)


# --------------------------------------------------------------- result


class _SqlCol:
    """Minimal schema entry so SqlResult prints like a Frame."""

    def __init__(self, type_: str):
        self.type = type_


class SqlResult:
    """Columnar host result of an aggregate query: ordered name ->
    array mapping (integer sums are exact Python ints in object
    arrays; means are float64)."""

    def __init__(self, names: List[str], columns: Dict[str, np.ndarray],
                 types: Dict[str, str], num_records: int):
        self.names = names
        self._columns = columns
        self.schema = {n: _SqlCol(types[n]) for n in names}
        self.num_records = num_records

    def __getitem__(self, name: str):
        return self._columns[name]

    def ok(self, name: str):
        return None

    def __len__(self) -> int:
        return self.num_records

    def keys(self):
        return list(self.names)

    def to_dict(self) -> Dict[str, np.ndarray]:
        return dict(self._columns)

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{n}:{self.schema[n].type}" for n in self.names
        )
        return f"SqlResult(rows={self.num_records}, columns=[{cols}])"


def _strip_explain(query: str) -> str:
    q = query.lstrip()
    if q[:8].lower() != "explain ":
        return query
    q = q[8:].lstrip()
    if q[:8].lower() == "analyze ":  # EXPLAIN ANALYZE prefix
        q = q[8:]
    return q


def table_refs(query: str) -> List[str]:
    """The bare (unquoted) FROM/JOIN table names of a statement
    (EXPLAIN prefix tolerated), in order — the CLI binds positional
    file arguments to these."""
    ast = _Parser(_strip_explain(query)).parse()
    out = []

    def _walk(a):
        if isinstance(a, _Union):
            for b in a.branches:
                _walk(b)
            return
        _collect(a.table)
        _collect(a.join_table)
        _walk_where(a.where)
        for it in a.items:
            if it.kind == "case":
                for cond, _v in it.branches:
                    _walk_where(cond)

    def _walk_where(e):
        # IN (SELECT ...) references tables too
        if isinstance(e, tuple) and len(e) == 3 \
                and isinstance(e[2], _InSubquery):
            _walk(e[2].ast)
        elif isinstance(e, tuple) and len(e) == 2 \
                and e[0] == "exists":
            _walk(e[1].ast)
        elif isinstance(e, tuple) and len(e) == 2 \
                and e[0] in ("and", "or"):
            for x in e[1]:
                _walk_where(x)
        elif isinstance(e, tuple) and len(e) == 2 and e[0] == "not":
            _walk_where(e[1])

    def _collect(t):
        if t is None:
            return
        if t[0] == "name":
            out.append(t[1])
        elif t[0] == "subquery":
            _walk(t[1][0])

    _walk(ast)
    return out


# ------------------------------------------------------------- executor


def _keys_align_with_on(ast) -> bool:
    """Syntactic check (no sources): every GROUP BY key names an ON
    column (either side, alias-stripped) and covers each pair once."""
    bare = [(a.split(".", 1)[-1], b.split(".", 1)[-1])
            for a, b in ast.join_on]
    if len(ast.group_by) != len(bare):
        return False
    taken = set()
    for ref in ast.group_by:
        c = ref.split(".", 1)[-1]
        hit = next((i for i, (a, b) in enumerate(bare)
                    if c in (a, b) and i not in taken), None)
        if hit is None:
            return False
        taken.add(hit)
    return True


def explain(query: str) -> str:
    """The compiled plan of a statement, as text: which device
    primitives it maps onto and what pushes down where. Parses only —
    no source needed, nothing executes."""
    return _explain_any(_Parser(query).parse())


def _explain_analyze(query: str, source, **kw) -> str:
    """EXPLAIN ANALYZE: the plan text PLUS an execution record —
    total wall time, result shape, and the deltas of the spans and
    counters the statement recorded into utils.metrics.GLOBAL (parse,
    group keys, typed parses, the window/setop/join executors and any
    instrumented pipeline stages the statement touched)."""
    import time as _time

    plan = explain(query)
    before = {k: (s.calls, s.seconds, s.bytes)
              for k, s in GLOBAL.stages.items()}
    t0 = _time.perf_counter()
    res = sql(query, source, **kw)
    dt = _time.perf_counter() - t0
    lines = [plan, "", "-- ANALYZE --"]
    try:
        shape = f"{len(res)} rows x {len(res.names)} cols"
    except Exception:
        shape = type(res).__name__
    lines.append(f"executed in {dt * 1e3:.1f} ms -> {shape}")
    for k, s in GLOBAL.stages.items():
        c0, t0_, b0 = before.get(k, (0, 0.0, 0))
        dc, dtm = s.calls - c0, s.seconds - t0_
        if dc > 0 and s.counter:
            lines.append(f"  {k:24s} {dc:4d} counted")
        elif dc > 0:
            db = s.bytes - b0
            rate = f"  {db / dtm / 1e9:.2f} GB/s" if db and dtm else ""
            lines.append(f"  {k:24s} {dc:4d} calls "
                         f"{dtm * 1e3:9.2f} ms{rate}")
    return "\n".join(lines)


def _explain_any(ast) -> str:
    if isinstance(ast, _Union):
        lines = []
        for i, b in enumerate(ast.branches):
            lines.append(f"UNION branch {i + 1}:")
            lines.extend("  " + ln
                         for ln in _explain_any(b).splitlines())
        lines.append("compound select -> host row-code set ops "
                     "(by position; names from branch 1)")
        labels = {
            "all": "UNION ALL (row concatenation)",
            "distinct": "plain UNION dedupe — device plan for fully "
                        "typed frames >= "
                        f"{_dev_setop_min_rows()} rows (one stable lex "
                        "device sort + run detection, setops.py), host "
                        "row codes otherwise "
                        "(np.unique over per-column row codes)",
            "except": "EXCEPT (distinct left rows absent from right) — "
                      "device stable-sort + segmented membership for "
                      "fully typed frames, host row-code set otherwise",
            "intersect": "INTERSECT (distinct left rows present in "
                         "right) — device stable-sort + segmented "
                         "membership for fully typed frames, host "
                         "row-code set otherwise",
        }
        for i, op in enumerate(ast.ops):
            lines.append(f"  joint {i + 1}: {labels[op]}")
        return "\n".join(lines)
    return _explain_ast(ast)


def _dev_window_min_rows() -> int:
    from .window import DEVICE_WINDOW_MIN_ROWS

    return DEVICE_WINDOW_MIN_ROWS


def _dev_setop_min_rows() -> int:
    from .setops import DEVICE_SETOP_MIN_ROWS

    return DEVICE_SETOP_MIN_ROWS


def _has_subquery(e) -> bool:
    if isinstance(e, tuple) and len(e) == 3:
        return isinstance(e[2], _InSubquery)
    if isinstance(e, tuple) and len(e) == 2 and e[0] in ("and", "or"):
        return any(_has_subquery(x) for x in e[1])
    if isinstance(e, tuple) and len(e) == 2 and e[0] == "not":
        return _has_subquery(e[1])
    return False


def _explain_ast(ast: _Ast) -> str:
    has_agg = any(it.kind == "agg" for it in ast.items)
    derived = ast.table[0] == "subquery" and ast.join_table is None
    lines = []
    if derived:
        sub, alias = ast.table[1]
        lines.append("FROM (subquery"
                     + (f" AS {alias}" if alias else "")
                     + ") -> inner plan:")
        lines.extend("  " + ln
                     for ln in _explain_any(sub).splitlines())
        lines.append("outer pipeline -> host twins over the derived "
                     "frame (_run_over_frame)")
    if ast.join_table is not None:
        if ast.join_how == "cross":
            lines.append(
                "JOIN (cross): Cartesian record-id product "
                "(join.join_records how='cross'), both sides "
                "materialize by gathered ids"
            )
        else:
            lines.append(
                f"JOIN ({ast.join_how}): device sort-merge "
                "(join.join_records — right side sorts once, "
                "per-left-row searchsorted, host pair expansion)"
            )
            on = ", ".join(f"{a} = {b}" for a, b in ast.join_on)
            lines.append(f"  on: {on}")
        for side, tbl in (("left", ast.table), ("right",
                                                ast.join_table)):
            if tbl is not None and tbl[0] == "subquery":
                lines.append(
                    f"  {side} side: derived table/CTE "
                    f"{tbl[1][1] or ''} materializes via the "
                    "round-trip CSV writer, then joins like a base "
                    "table (sql._frame_join_source)")
    if ast.where is not None:
        tgt = ("host mask over the joined frame"
               if ast.join_table is not None
               else "host mask over the derived frame" if derived
               else "device predicate masks (query.select_records "
               "pushdown: only matching rows are ever gathered)")
        lines.append(f"WHERE -> {tgt}")
        lines.append(f"  tree: {ast.where!r}")
        if _has_subquery(ast.where):
            lines.append(
                "  subqueries run FIRST (their own device pushdowns);"
                " values inline into the leaf before compilation")
    if ast.group_by or (ast.distinct and not has_agg):
        if derived:
            how = ("host group over the derived frame "
                   "(query._group_multi)")
        elif ast.join_table is None:
            how = ("device group-by (query.groupby_typed: one stable "
                   "key sort + segment reduces; exact digit-split int "
                   "sums)")
        elif ast.group_by and ast.join_how in ("inner", "left", "right") \
                and _keys_align_with_on(ast):
            how = ("device group-by PER SIDE + host group combine "
                   "(join-aggregate pushdown: group keys = join keys, "
                   "so SUM/COUNT scale by the other side's match count "
                   "and the joined frame is never materialized; falls "
                   "back to the host group if a WHERE conjunct "
                   "straddles the join or key types disagree)")
        else:
            how = "host group over the joined frame (query._group_multi)"
        keys = ast.group_by or [it.col for it in ast.items
                                if it.kind == "col"]
        lines.append(f"GROUP BY {', '.join(map(str, keys))} -> {how}")
    elif has_agg:
        lines.append(
            "scalar aggregates -> device column stats "
            "(query.column_stats)"
            if ast.join_table is None and not derived
            else "scalar aggregates -> host reduce over the "
            + ("derived" if derived else "joined") + " frame"
        )
    if any(it.kind == "agg" and it.distinct for it in ast.items):
        lines.append(
            "COUNT(DISTINCT) -> device group-by keyed by "
            "(group keys + col): one row per distinct pair, "
            "O(#pairs) host tally"
            if ast.join_table is None and not derived
            else "COUNT(DISTINCT) -> host unique tally over the "
            + ("derived" if derived else "joined") + " frame"
        )
    if ast.having is not None:
        lines.append(f"HAVING (post-merge group filter): {ast.having!r}")
    if ast.order_by:
        keys = ", ".join(
            f"{it.name()} {'DESC' if d else 'ASC'}"
            for it, d in ast.order_by
        )
        where_ = ("host stable multi-key sort"
                  if (ast.join_table is not None or ast.group_by
                      or ast.distinct or derived)
                  else "device sort (top-k when LIMIT)")
        lines.append(f"ORDER BY {keys} -> {where_}")
    wins = [it for it in ast.items if it.kind == "window"]
    if wins:
        lines.append(
            "WINDOW "
            + ", ".join(it.name() for it in wins)
            + " -> device plan: one lexicographic device sort + "
            "segmented scans, peer frames via suffix-min gather "
            f"(window.window_column; frames under "
            f"{_dev_window_min_rows()} rows, float sums, or >=2^20-row "
            "partitions fall back to the host peer-frame pass)")
    if ast.limit is not None:
        lines.append(f"LIMIT {ast.limit}"
                     + (f" OFFSET {ast.offset}" if ast.offset else ""))
    items = ", ".join(
        "*" if it.kind == "star" else it.name() for it in ast.items
    )
    lines.append(f"SELECT {items} -> "
                 + ("SqlResult (host arrays)"
                    if has_agg or ast.group_by or ast.distinct
                    else "Frame (typed device-parsed columns)"))
    return "\n".join(lines)


def sql(query: str, source=None, *, tables: Optional[Dict] = None,
        schema: Optional[Dict] = None, right_schema: Optional[Dict] = None,
        engine: str = "offsets", backend: str = "auto", dialect=None,
        sample: int = 256, device="cuda"):
    """Run a SELECT against CSV source(s). See the module docstring for
    the grammar.

    source — the table when FROM names exactly one: a path, bytes, any
             tape, or a CsvCorpus. With a JOIN, pass both via `tables`
             (FROM/JOIN identifiers -> sources) or quote file paths in
             the statement itself.
    schema — optional {column: type spec} overriding inference for the
             FROM table (e.g. {"qty": "int32"} when a stray bad row
             would otherwise flip a column to str); `right_schema`
             covers the JOINed table.
    device — where paths and bytes are indexed and where the device
             executors (predicates, sorts, group-bys, joins, windows,
             set operations) run: "cuda" (the default; raises without
             a card) or "cpu"; a tape or corpus passed in keeps its own.
    Returns a Frame (plain selection / join) or SqlResult (aggregate /
    GROUP BY / DISTINCT). A statement prefixed with EXPLAIN returns
    the plan text instead (see explain()); EXPLAIN ANALYZE executes
    the statement and returns the plan plus measured wall time, result
    shape, and per-stage spans (window/setop/join executors)."""
    device = resolve_device(device)
    stripped = query.lstrip()
    if stripped[:16].lower().startswith("explain analyze"):
        real = stripped[15:].lstrip()
        return _explain_analyze(real, source, tables=tables,
                                schema=schema,
                                right_schema=right_schema,
                                engine=engine, backend=backend,
                                dialect=dialect, sample=sample,
                                device=device)
    if stripped[:8].lower() == "explain ":
        return explain(_strip_explain(query))
    with GLOBAL.span("sql.parse"):
        ast = _Parser(query).parse()

    def _resolve(table, fallback_ok: bool):
        kind, val = table
        if kind == "path":
            return val
        if tables is not None and val in tables:
            return tables[val]
        if fallback_ok and source is not None:
            return source
        raise SqlError(
            f"table {val!r} is not in `tables` "
            f"({sorted(tables) if tables else []}) and no positional "
            "source was given"
        )

    kw = dict(engine=engine, backend=backend, dialect=dialect,
              sample=sample, schema=schema, right_schema=right_schema,
              device=device)
    return _dispatch(ast, _resolve, kw)


def _dispatch(ast, resolve_table, kw):
    """Route a (sub)select to its executor. Recurses for derived
    tables: the inner select runs first (device paths and all), its
    materialized result becomes the outer query's source frame.
    UNION ALL runs every branch and concatenates the frames."""
    if isinstance(ast, _Ast):
        _resolve_in_subqueries(ast, resolve_table, kw)
    if isinstance(ast, _Union):
        acc = _as_frame(_dispatch(ast.branches[0], resolve_table, kw))
        for op, b in zip(ast.ops, ast.branches[1:]):
            nxt = _as_frame(_dispatch(b, resolve_table, kw))
            if op in ("except", "intersect"):
                acc = _setop_frames(acc, nxt, op, kw["device"])
            else:
                acc = _union_frames([acc, nxt])
                if op == "distinct":
                    acc = _dedupe_frame(acc, kw["device"])
        return acc
    if ast.join_table is not None and (
            ast.table[0] == "subquery"
            or ast.join_table[0] == "subquery"):
        # derived table / CTE as a JOIN side: materialize it and feed
        # the join through the round-trip CSV writer (write_csv is
        # designed so read_typed(write_csv(f)) round-trips exactly —
        # quoting, canonical floats, empty cells for NULLs), carrying
        # the frame's own schema so nothing re-infers
        if ast.table[0] == "subquery":
            sub, alias = ast.table[1]
            left_src, sch = _frame_join_source(sub, resolve_table, kw)
            kw = dict(kw, schema=sch)
            ast.table_alias = ast.table_alias or alias or "l"
            ast.table = ("name", ast.table_alias)
        else:
            left_src = resolve_table(ast.table, True)
        if ast.join_table[0] == "subquery":
            sub, alias = ast.join_table[1]
            right_src, sch = _frame_join_source(sub, resolve_table, kw)
            kw = dict(kw, right_schema=sch)
            ast.join_alias = ast.join_alias or alias or "r"
            ast.join_table = ("name", ast.join_alias)
        else:
            right_src = resolve_table(ast.join_table, False)
        return _run_join(ast, left_src, right_src, kw)
    if ast.table[0] == "subquery":
        sub, alias = ast.table[1]
        fr = _as_frame(_dispatch(sub, resolve_table, kw))
        if alias:
            _dequalify_ast(ast, alias)

        def _res(c: str) -> str:
            if c in fr._columns:
                return c
            raise SqlError(
                f"no column {c!r} in the derived table "
                f"(columns: {list(fr.names)})"
            )

        return _run_over_frame(ast, fr, _res, kw["device"],
                               what="derived table")
    if ast.join_table is None:
        if ast.table_alias:
            _dequalify_ast(ast, ast.table_alias)
        elif ast.table[0] == "name":
            _dequalify_ast(ast, ast.table[1])
    if ast.join_table is not None:
        return _run_join(ast, resolve_table(ast.table, True),
                         resolve_table(ast.join_table, False), kw)
    src = resolve_table(ast.table, True)
    has_agg = any(it.kind == "agg" for it in ast.items)
    if ast.group_by or (ast.distinct and not has_agg):
        return _run_groupby(ast, src, kw)
    if has_agg:
        return _run_scalar_aggs(ast, src, kw)
    return _run_select(ast, src, kw)


def _union_frames(frames):
    """Concatenate UNION ALL branch frames by column position. Output
    names come from the first branch; column types must agree per
    position (both-text counts as agreeing). Parse-validity masks
    concatenate; exact object-int columns stay object."""
    from .frame import Frame

    first = frames[0]
    width = len(first.names)
    names = list(first.names)
    for fr in frames:
        if len(fr.names) != width:
            raise SqlError(
                f"UNION ALL branches select {width} vs "
                f"{len(fr.names)} columns"
            )
    cols, oks, schema = {}, {}, {}
    total = sum(len(fr) for fr in frames)
    for j, nm in enumerate(names):
        parts, okparts, types = [], [], []
        for fr in frames:
            src = fr.names[j]
            parts.append(np.asarray(fr._columns[src]))
            m = fr._ok[src]
            okparts.append(np.ones(len(fr), bool) if m is None
                           else np.asarray(m, bool))
            types.append(fr.schema[src].type)

        def _kindof(t):
            return "text" if t in ("str", "bytes") else t

        if any(_kindof(t) != _kindof(types[0]) for t in types):
            raise SqlError(
                f"UNION ALL column {j + 1} mixes types {types} — "
                "cast inside the branches (or give explicit schemas)"
            )
        try:
            cols[nm] = np.concatenate(parts)
        except (TypeError, ValueError):
            cols[nm] = np.concatenate(
                [p.astype(object) for p in parts])
        ok = np.concatenate(okparts) if okparts else np.zeros(0, bool)
        oks[nm] = None if ok.all() else ok
        schema[nm] = first.schema[first.names[j]]
    return Frame(names, cols, oks, schema, total)


def _referenced_cols(ast):
    """Bare column names a statement references, or None when unknown
    (a star item). Used to prune the session schema before running an
    IN (SELECT ...) against a DIFFERENT table — schema entries for
    columns the inner table doesn't have must not reach its
    read_typed."""
    from .query import TextFold, VExpr, _where_leaves

    if isinstance(ast, _Union):
        outs = [_referenced_cols(b) for b in ast.branches]
        if any(o is None for o in outs):
            return None
        return set().union(*outs)
    out = set()

    def add(ref):
        if isinstance(ref, str):
            out.add(ref)
            out.add(ref.split(".", 1)[-1])
        elif isinstance(ref, TextFold):
            add(ref.col)
        elif isinstance(ref, VExpr):
            for c in ref.columns():
                add(c)

    def add_where(e):
        if e is None:
            return
        for leaf in _where_leaves(e):
            if isinstance(leaf[0], tuple):  # composite in_rows key
                for c in leaf[0]:
                    add(c)
            else:
                add(leaf[0])
            if isinstance(leaf[2], VExpr):
                add(leaf[2])

    for it in ast.items:
        if it.kind == "star":
            return None
        for c in _item_input_cols(it):
            add(c)
    for it, _d in ast.order_by:
        if it.kind != "star":
            for c in _item_input_cols(it):
                add(c)
    for k in ast.group_by:
        add(k)
    add_where(ast.where)
    add_where(ast.having)
    return out


@GLOBAL.span("sql.subquery")
def _in_subquery_values(sub: _InSubquery, resolve_table, kw):
    """Run the inner select of `col IN (SELECT ...)` and return its
    distinct non-NULL values as Python scalars (the literal list the
    IN leaf then compiles against, device pushdown included)."""
    kw2 = kw
    if kw.get("schema"):
        refs = _referenced_cols(sub.ast)
        if refs is not None:
            pruned = {k: v for k, v in kw["schema"].items()
                      if k in refs}
            kw2 = dict(kw, schema=(pruned or None))
    fr = _as_frame(_dispatch(sub.ast, resolve_table, kw2))
    if len(fr.names) != 1:
        raise SqlError(
            f"IN (SELECT ...) needs exactly one output column, "
            f"got {fr.names}"
        )
    nm = fr.names[0]
    ok = fr._ok[nm]
    out, seen = [], set()
    for i, v in enumerate(np.asarray(fr._columns[nm])):
        if ok is not None and not ok[i]:
            continue  # NULL in the list can never equal a value here
        if isinstance(v, (bytes, np.bytes_)):
            v = bytes(v).decode("utf-8", "surrogateescape")
        elif isinstance(v, np.integer):
            v = int(v)
        elif isinstance(v, np.floating):
            v = float(v)
        elif isinstance(v, np.str_):
            v = str(v)
        if v not in seen:
            seen.add(v)
            out.append(v)
    return out


@GLOBAL.span("sql.subquery")
def _in_subquery_rows(sub: _InSubquery, resolve_table, kw) -> list:
    """Materialize a MULTI-column subquery to a deduped list of row
    tuples for the composite in_rows leaf. Rows with any NULL key are
    dropped (SQL: an equality against NULL is UNKNOWN — such an inner
    row can never witness the EXISTS)."""
    kw2 = kw
    if kw.get("schema"):
        refs = _referenced_cols(sub.ast)
        if refs is not None:
            pruned = {k: v for k, v in kw["schema"].items()
                      if k in refs}
            kw2 = dict(kw, schema=(pruned or None))
    fr = _as_frame(_dispatch(sub.ast, resolve_table, kw2))
    from .query import _norm_row_key

    cols = [np.asarray(fr._columns[nm]) for nm in fr.names]
    oks = [fr._ok[nm] for nm in fr.names]
    n = len(fr)
    ok_all = np.ones(n, bool)
    for ok in oks:
        if ok is not None:
            ok_all &= np.asarray(ok, bool)
    rows = np.flatnonzero(ok_all)
    # dedupe via per-column codes BEFORE building Python tuples, so
    # the per-row loop only runs over the DISTINCT rows (typed columns;
    # non-factorizable ones fall back to the tuple-set scan)
    if rows.size:
        from .window import factorize_key

        combined = None
        space = 1
        codable = True
        for c in cols:
            code = factorize_key(c[rows], None)
            if code is None:
                codable = False
                break
            g = int(code.max(initial=0)) + 1
            if space * g >= 2**62:
                codable = False
                break
            combined = (code.astype(np.int64) if combined is None
                        else combined * g + code)
            space *= g
        if codable and combined is not None:
            _u, first = np.unique(combined, return_index=True)
            rows = rows[np.sort(first)]
            return [tuple(_norm_row_key(c[i]) for c in cols)
                    for i in rows]
    out, seen = [], set()
    for i in rows:
        t = tuple(_norm_row_key(c[i]) for c in cols)
        if t not in seen:
            seen.add(t)
            out.append(t)
    return out


def _scalar_subquery_value(sub: _InSubquery, resolve_table, kw):
    """The single value of a scalar subquery comparison, as a Python
    scalar; None for an empty result or a NULL value (SQL: the
    comparison is unknown, matching nothing); >1 row raises."""
    kw2 = kw
    if kw.get("schema"):
        refs = _referenced_cols(sub.ast)
        if refs is not None:
            pruned = {k: v for k, v in kw["schema"].items()
                      if k in refs}
            kw2 = dict(kw, schema=(pruned or None))
    fr = _as_frame(_dispatch(sub.ast, resolve_table, kw2))
    if len(fr.names) != 1:
        raise SqlError(
            f"a scalar subquery needs exactly one output column, "
            f"got {fr.names}"
        )
    if len(fr) > 1:
        raise SqlError(
            f"scalar subquery returned {len(fr)} rows (expected at "
            "most one — aggregate it, or add LIMIT 1)"
        )
    if len(fr) == 0:
        return None
    nm = fr.names[0]
    ok = fr._ok[nm]
    if ok is not None and not ok[0]:
        return None
    v = np.asarray(fr._columns[nm])[0]
    if v is None:
        return None
    if isinstance(v, (bytes, np.bytes_)):
        return bytes(v).decode("utf-8", "surrogateescape")
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, np.str_):
        return str(v)
    return v


def _outer_qualifiers(ast: _Ast) -> set:
    """The qualifier names (alias or bare table name) a nested
    subquery could use to reference THIS select's tables."""
    out = set()
    if ast.table_alias:
        out.add(ast.table_alias)
    elif ast.table[0] == "name":
        out.add(ast.table[1])
    if ast.join_table is not None:
        if ast.join_alias:
            out.add(ast.join_alias)
        elif ast.join_table[0] == "name":
            out.add(ast.join_table[1])
    return out


def _resolve_exists(sub: _InSubquery, ast: _Ast, resolve_table, kw):
    """Resolve one [NOT] EXISTS (SELECT ...) leaf.

    - UNCORRELATED (the inner WHERE references no outer qualifier):
      run the inner select once, return True/False — the caller folds
      the constant through the boolean tree. Note EXISTS over a pure
      aggregate (SELECT COUNT(*) ...) is always True: aggregates
      return one row, per SQL.
    - CORRELATED via a single top-level equality conjunct
      `inner.col = outer.col`: rewrite to the equivalent semi-join
      `outer_col IN (SELECT inner_col FROM ... WHERE rest)`, riding
      the IN machinery (device pushdowns included). Inner aliases
      shadow outer ones (SQL scoping). Anything more entangled
      (inequality correlation, OR-nested correlation, correlated
      GROUP BY/LIMIT) raises a clear SqlError."""
    inner = sub.ast
    inner_quals = (set() if isinstance(inner, _Union)
                   else _outer_qualifiers(inner))
    outer_quals = _outer_qualifiers(ast) - inner_quals

    def _corr_col(ref) -> Optional[str]:
        if isinstance(ref, str) and "." in ref \
                and ref.split(".", 1)[0] in outer_quals:
            return ref
        return None

    def _tree_corr_refs(e) -> List[str]:
        from .query import TextFold, VExpr, _where_leaves

        out = []
        for leaf in _where_leaves(e):
            cands = []
            lhs = leaf[0]
            if isinstance(lhs, TextFold):
                cands.append(lhs.col)
            elif isinstance(lhs, VExpr):
                cands.extend(lhs.columns())
            else:
                cands.append(lhs)
            if isinstance(leaf[2], VExpr):
                cands.extend(leaf[2].columns())
            out.extend(c for c in cands if _corr_col(c))
        return out

    if isinstance(inner, _Union):
        for b in inner.branches:
            if b.where is not None and _tree_corr_refs(b.where):
                raise SqlError(
                    "correlated EXISTS over a compound (UNION/...) "
                    "subquery is not supported"
                )
        return _exists_uncorrelated(inner, resolve_table, kw)

    corr = ([] if inner.where is None
            else _tree_corr_refs(inner.where))
    if not corr:
        return _exists_uncorrelated(inner, resolve_table, kw)

    # correlated: find THE correlation conjunct at the top level
    from .query import VExpr

    conjuncts = (list(inner.where[1])
                 if (isinstance(inner.where, tuple)
                     and inner.where[0] == "and")
                 else [inner.where])

    def _split_eq(leaf):
        """(outer_col, inner_col) when `leaf` is an equality between
        one outer-qualified column and one inner column."""
        if not (isinstance(leaf, tuple) and len(leaf) == 3
                and leaf[1] == "=="):
            return None
        a, b = leaf[0], leaf[2]
        if not (isinstance(a, VExpr) and isinstance(b, VExpr)):
            return None
        ta, tb = a.tree, b.tree
        if ta[0] != "col" or tb[0] != "col":
            return None
        ca, cb = ta[1], tb[1]
        if _corr_col(ca) and not _corr_col(cb):
            return ca, cb
        if _corr_col(cb) and not _corr_col(ca):
            return cb, ca
        return None

    if inner.group_by or inner.having is not None or inner.limit \
            is not None or inner.offset:
        raise SqlError(
            "correlated EXISTS cannot combine with GROUP BY/HAVING/"
            "LIMIT in the subquery"
        )
    hits = [(i, _split_eq(c)) for i, c in enumerate(conjuncts)]
    hits = [(i, h) for i, h in hits if h is not None]
    rest = [c for i, c in enumerate(conjuncts)
            if not any(i == j for j, _ in hits)]
    if not hits or any(_tree_corr_refs(c) for c in rest):
        # inequality / OR-nested correlation: the general theta path —
        # evaluate EXISTS once per DISTINCT outer key tuple (blocked
        # vectorized pairwise predicate) and ride the in/in_rows leaf
        # machinery with the precomputed tuple set (VERDICT r4 item 8)
        return _exists_correlated_general(
            ast, inner, conjuncts, resolve_table, kw,
            _corr_col, _tree_corr_refs)
    inner.order_by = []
    inner.distinct = False  # IN dedupes
    inner.where = (None if not rest
                   else rest[0] if len(rest) == 1
                   else ("and", rest))
    if len(hits) == 1:
        outer_col, inner_col = hits[0][1]
        inner.items = [_Item("col", col=inner_col)]
        return (outer_col, "in", _InSubquery(inner))
    # multi-key correlation -> composite semi-join: (o1, o2, ...) IN
    # (SELECT i1, i2, ... FROM ... WHERE rest), compiled by the
    # in_rows leaf (query._in_rows_mask / sql._frame_leaf)
    outer_cols = tuple(h[0] for _i, h in hits)
    inner.items = [_Item("col", col=h[1]) for _i, h in hits]
    return (outer_cols, "in_rows", _InSubquery(inner))


#: pairwise-evaluation guard: distinct outer key tuples x inner rows
#: (the blocked broadcast is O(m*n) — beyond this, the honest answer
#: is a JOIN, not an hour of broadcasting)
_EXISTS_PAIR_LIMIT = 2**32
_EXISTS_BLOCK_CELLS = 2**24


def _exists_correlated_general(ast, inner, conjuncts, resolve_table,
                               kw, _corr_col, _tree_corr_refs):
    """Correlated EXISTS beyond pure top-level equality (VERDICT r4
    item 8): inequality conjuncts (inner.b < outer.y) and OR-nested
    correlation ((inner.a = outer.x OR inner.b > outer.y) AND ...).

    The verdict depends only on the outer row's correlated column
    VALUES, so EXISTS evaluates once per DISTINCT outer key tuple — a
    blocked vectorized pairwise predicate (theta semi-join by
    enumeration, size-guarded) — and the result rides the existing
    in/in_rows leaf machinery as a precomputed value set.
    Non-correlated conjuncts push into the inner WHERE first. NULL
    semantics match the layer: a comparison against a parse-failure
    row never holds; NOT is a pure complement (query.py's `not`)."""
    from .query import TextFold, VExpr, _where_leaves

    if getattr(ast, "join_table", None) is not None:
        raise SqlError(
            "correlated EXISTS with inequality/OR correlation is not "
            "supported when the outer SELECT is a JOIN — rewrite the "
            "EXISTS as a JOIN"
        )
    push = [c for c in conjuncts if not _tree_corr_refs(c)]
    corr = [c for c in conjuncts if _tree_corr_refs(c)]
    tree = corr[0] if len(corr) == 1 else ("and", corr)

    outer_refs: List[str] = []
    inner_refs: List[str] = []
    _CMP = {"==", "!=", "<", "<=", ">", ">="}

    def _side(x):
        if isinstance(x, VExpr):
            t = x.tree
            if t[0] == "col":
                x = t[1]
            elif t[0] == "lit":
                return ("lit", t[1])
            else:
                raise SqlError(
                    "correlated EXISTS predicates compare plain "
                    "columns (arithmetic inside the correlated "
                    "predicate is not supported — rewrite as a JOIN)"
                )
        if isinstance(x, TextFold):
            raise SqlError(
                "UPPER()/LOWER() inside a correlated EXISTS "
                "predicate is not supported — rewrite as a JOIN"
            )
        if isinstance(x, str):
            if _corr_col(x):
                if x not in outer_refs:
                    outer_refs.append(x)
                return ("outer", x)
            if x not in inner_refs:
                inner_refs.append(x)
            return ("inner", x)
        return ("lit", x)

    def _validate(e):
        if isinstance(e, tuple) and len(e) == 2 and e[0] in ("and",
                                                             "or"):
            return (e[0], [_validate(x) for x in e[1]])
        if isinstance(e, tuple) and len(e) == 2 and e[0] == "not":
            return ("not", _validate(e[1]))
        if isinstance(e, tuple) and len(e) == 3 and e[1] in _CMP:
            return ("leaf", _side(e[0]), e[1], _side(e[2]))
        raise SqlError(
            "correlated EXISTS predicates support column comparisons "
            f"(= != < <= > >=) combined with AND/OR/NOT; got {e!r} — "
            "rewrite as a JOIN"
        )

    vtree = _validate(tree)

    def _pruned_kw(refs):
        if not kw.get("schema"):
            return kw
        pruned = {k: v for k, v in kw["schema"].items() if k in refs}
        return dict(kw, schema=(pruned or None))

    # inner rows (non-correlated conjuncts pushed down)
    inner2 = _Ast()
    inner2.table = inner.table
    inner2.table_alias = inner.table_alias
    inner2.items = [_Item("col", col=c) for c in inner_refs] \
        or [_Item("star")]
    inner2.where = (None if not push
                    else push[0] if len(push) == 1
                    else ("and", push))
    irefs = _referenced_cols(inner2)
    ifr = _as_frame(_dispatch(inner2, resolve_table,
                              _pruned_kw(irefs if irefs is not None
                                         else set())))
    ni = len(ifr)

    # outer key columns as a PLAIN selection (a Frame keeps the
    # parse-validity masks DISTINCT would drop — NULL-keyed outer
    # rows can still satisfy EXISTS through another OR arm); the
    # verdict is per key tuple, duplicates just re-evaluate
    outer_cols = [c.split(".", 1)[1] for c in outer_refs]
    outer2 = _Ast()
    outer2.table = ast.table
    outer2.table_alias = ast.table_alias
    outer2.items = [_Item("col", col=c) for c in outer_cols]
    ofr = _as_frame(_dispatch(outer2, resolve_table,
                              _pruned_kw(set(outer_cols))))
    m = len(ofr)

    leaf_target = (outer_refs[0] if len(outer_refs) == 1
                   else tuple(outer_refs))
    empty = ((leaf_target, "in", [])
             if len(outer_refs) == 1
             else (leaf_target, "in_rows", []))
    if ni == 0 or m == 0:
        return empty

    def _arr(src, fr, name):
        vals = np.asarray(fr._columns[name])
        ok = fr._ok.get(name)
        ok = (np.ones(len(fr), bool) if ok is None
              else np.asarray(ok, bool))
        return vals, ok

    ocols = {c: _arr("o", ofr, n)
             for c, n in zip(outer_refs, ofr.names)}
    icols = {c: _arr("i", ifr, n)
             for c, n in zip(inner_refs, ifr.names)}

    # dedupe outer rows by key TUPLE before the pairwise evaluation
    # (the verdict is per tuple; NULL is its own equality class via
    # factorize_key's code) — a plain selection was read to keep the
    # parse-validity masks DISTINCT would drop
    from .window import factorize_key

    combined, space = None, 1
    for vals, ok in ocols.values():
        c = factorize_key(vals, ok)
        if c is None:
            combined = None
            break
        g = int(c.max(initial=0)) + 1
        if space * g >= 2**62:
            combined = None
            break
        combined = (c.astype(np.int64) if combined is None
                    else combined * g + c)
        space *= g
    if combined is not None:
        _u, first = np.unique(combined, return_index=True)
        reps = np.sort(first)
        ocols = {c: (vals[reps], ok[reps])
                 for c, (vals, ok) in ocols.items()}
        m = reps.size
    if m * ni > _EXISTS_PAIR_LIMIT:
        raise SqlError(
            "correlated EXISTS with inequality/OR correlation "
            f"evaluates {m} distinct outer keys x {ni} inner rows "
            f"pairwise (> {_EXISTS_PAIR_LIMIT}); rewrite as a JOIN"
        )

    def _block_eval(e, sl):
        """(b, ni) bool for outer rows `sl` (broadcast shapes)."""
        if e[0] in ("and", "or"):
            masks = [_block_eval(x, sl) for x in e[1]]
            out = masks[0]
            for x in masks[1:]:
                out = (out & x) if e[0] == "and" else (out | x)
            return out
        if e[0] == "not":
            return ~_block_eval(e[1], sl)
        _tag, lhs, op, rhs = e

        def _vals_ok(side):
            kind, v = side
            if kind == "lit":
                return v, None
            if kind == "outer":
                vv, ok = ocols[v]
                return vv[sl][:, None], ok[sl][:, None]
            vv, ok = icols[v]
            return vv[None, :], ok[None, :]

        a, aok = _vals_ok(lhs)
        b, bok = _vals_ok(rhs)
        try:
            with np.errstate(invalid="ignore"):
                if op == "==":
                    r = a == b
                elif op == "!=":
                    r = a != b
                elif op == "<":
                    r = a < b
                elif op == "<=":
                    r = a <= b
                elif op == ">":
                    r = a > b
                else:
                    r = a >= b
        except TypeError:
            raise SqlError(
                "correlated EXISTS comparison between incomparable "
                f"column types ({op}); give both columns a schema "
                "type"
            ) from None
        r = np.asarray(r, bool)
        if aok is not None:
            r = r & aok
        if bok is not None:
            r = r & bok
        return r

    block = max(1, _EXISTS_BLOCK_CELLS // max(ni, 1))
    hit = np.zeros(m, bool)
    for s in range(0, m, block):
        sl = slice(s, min(s + block, m))
        hit[sl] = _block_eval(vtree, sl).any(axis=1)

    from .query import _norm_row_key

    rows = np.flatnonzero(hit)
    # read back through ocols: it carries the (possibly deduplicated)
    # arrays the pairwise evaluation actually indexed
    cols = [ocols[c][0] for c in outer_refs]
    oks = [ocols[c][1] for c in outer_refs]
    # the in/in_rows machinery is equality-based: a NULL key never
    # matches. Under inequality/OR correlation a NULL-keyed outer row
    # CAN satisfy EXISTS through another arm — those tuples become
    # explicit (col = v AND col2 IS NULL ...) disjuncts instead.
    plain_rows = [int(i) for i in rows if all(o[i] for o in oks)]
    null_rows = [int(i) for i in rows if not all(o[i] for o in oks)]
    if len(outer_refs) == 1:
        vals = []
        seen = set()
        for i in plain_rows:
            v = _norm_row_key(cols[0][i])
            if v not in seen:
                seen.add(v)
                vals.append(v)
        base = (leaf_target, "in", vals)
        if null_rows:
            # single key, some NULL tuple hit: every NULL-keyed outer
            # row matches (they are all the same equality class)
            return ("or", [base, (leaf_target, "isnull", None)])
        return base
    tuples, seen = [], set()
    for i in plain_rows:
        t = tuple(_norm_row_key(c[i]) for c in cols)
        if t not in seen:
            seen.add(t)
            tuples.append(t)
    base = (leaf_target, "in_rows", tuples)
    if not null_rows:
        return base
    # distinct NULL-pattern tuples (NULL marked by a sentinel)
    npat, seen = [], set()
    for i in null_rows:
        t = tuple(_norm_row_key(c[i]) if o[i] else None
                  for c, o in zip(cols, oks))
        if t not in seen:
            seen.add(t)
            npat.append(t)
    if len(npat) > 256:
        raise SqlError(
            "correlated EXISTS produced too many NULL-keyed outer "
            f"tuples ({len(npat)}) to expand; rewrite as a JOIN"
        )
    disj = [base]
    for t in npat:
        conj = [(ref, "==", v) if v is not None
                else (ref, "isnull", None)
                for ref, v in zip(outer_refs, t)]
        disj.append(conj[0] if len(conj) == 1 else ("and", conj))
    return ("or", disj)


def _exists_uncorrelated(inner, resolve_table, kw) -> bool:
    kw2 = kw
    if kw.get("schema"):
        refs = _referenced_cols(inner)
        if refs is not None:
            pruned = {k: v for k, v in kw["schema"].items()
                      if k in refs}
            kw2 = dict(kw, schema=(pruned or None))
    fr = _as_frame(_dispatch(inner, resolve_table, kw2))
    return len(fr) > 0


def _false_where_leaf(ast: _Ast, resolve_table, kw):
    """A match-nothing predicate for a WHERE that folded to constant
    FALSE (e.g. NOT EXISTS over a non-empty table): an empty IN list
    on a column the statement already references; the source header
    is resolved only when the statement names no column at all
    (SELECT COUNT(*) / SELECT *)."""
    for it in ast.items:
        for c in _item_input_cols(it):
            if isinstance(c, str):
                return (c, "in", [])
    for k in ast.group_by:
        if isinstance(k, str):
            return (k, "in", [])
    for it, _d in ast.order_by:
        if it.kind != "star":
            for c in _item_input_cols(it):
                if isinstance(c, str):
                    return (c, "in", [])
    from .frame import _resolve_tape

    try:
        src = resolve_table(ast.table, True)
        _t, names = _resolve_tape(src, kw["dialect"], kw["backend"],
                                  kw["engine"], False, kw["device"])
        return (names[0], "in", [])
    except SqlError:
        raise
    except Exception as e:
        raise SqlError(
            "the WHERE clause folded to constant FALSE but no column "
            f"is available to encode a match-nothing predicate ({e})"
        )


def _resolve_in_subqueries(ast: _Ast, resolve_table, kw) -> None:
    """Replace every _InSubquery in the statement's WHERE tree (and
    CASE WHEN conditions) with its materialized value list, in place,
    before any executor compiles the predicates. EXISTS leaves resolve
    to True/False constants (uncorrelated) or rewrite to IN
    (correlated) — constants fold through AND/OR/NOT; a whole-tree
    True drops the WHERE, a False compiles to a match-nothing leaf.
    Scalar subqueries used as VALUES inside expression trees
    (SELECT (SELECT MAX(x) FROM u) AS m; WHERE q > (SELECT ...) + 1)
    resolve their ("ssub", _InSubquery) nodes to literals here too."""
    from .query import VExpr

    def _res_vtree(t):
        if not isinstance(t, tuple):
            return t
        if t[0] == "ssub":
            v = _scalar_subquery_value(t[1], resolve_table, kw)
            if v is None:
                raise SqlError(
                    "scalar subquery value produced NULL (empty "
                    "result or NULL value) — COALESCE/filter inside "
                    "the subquery"
                )
            return ("lit", v)
        return (t[0],) + tuple(_res_vtree(x) for x in t[1:])

    def _has_ssub(t):
        return isinstance(t, tuple) and (
            t[0] == "ssub" or any(_has_ssub(x) for x in t[1:]))

    def _res_ve(ve):
        if isinstance(ve, VExpr) and _has_ssub(ve.tree):
            return VExpr(_res_vtree(ve.tree))
        return ve

    def walk(e):
        if e is None:
            return None
        if isinstance(e, tuple) and len(e) == 2 and e[0] == "exists":
            r = _resolve_exists(e[1], ast, resolve_table, kw)
            return r if isinstance(r, bool) else walk(r)
        if isinstance(e, tuple) and len(e) == 3:
            if any(isinstance(s, VExpr) and _has_ssub(s.tree)
                   for s in (e[0], e[2])):
                return (_res_ve(e[0]), e[1], _res_ve(e[2]))
            if isinstance(e[2], _InSubquery):
                if e[2].scalar:
                    v = _scalar_subquery_value(e[2], resolve_table,
                                               kw)
                    if v is None:
                        # empty / NULL scalar: SQL NULL comparison
                        # matches nothing — an empty IN list compiles
                        # to exactly that
                        return (e[0], "in", [])
                    if isinstance(v, float) and isinstance(e[0], str):
                        # a fractional scalar (e.g. AVG) vs an int32
                        # column: the arithmetic comparison promotes
                        # both sides to float32 on device, instead of
                        # the integral-literal strictness of plain
                        # typed leaves
                        return (VExpr(("col", e[0])), e[1],
                                VExpr(("lit", v)))
                    return (e[0], e[1], v)
                if e[1] == "in_rows":
                    return (e[0], "in_rows",
                            _in_subquery_rows(e[2], resolve_table, kw))
                return (e[0], e[1],
                        _in_subquery_values(e[2], resolve_table, kw))
            return e
        if isinstance(e, tuple) and len(e) == 2 and e[0] in ("and",
                                                             "or"):
            kids = [walk(x) for x in e[1]]
            if e[0] == "and":
                if any(k is False for k in kids):
                    return False
                kids = [k for k in kids if k is not True]
                if not kids:
                    return True
            else:
                if any(k is True for k in kids):
                    return True
                kids = [k for k in kids if k is not False]
                if not kids:
                    return False
            return kids[0] if len(kids) == 1 else (e[0], kids)
        if isinstance(e, tuple) and len(e) == 2 and e[0] == "not":
            k = walk(e[1])
            if isinstance(k, bool):
                return not k
            return ("not", k)
        return e

    def as_leaf(cond):
        # a CASE WHEN condition that folded to a constant still needs
        # a compilable predicate tree
        if cond is False:
            return _false_where_leaf(ast, resolve_table, kw)
        if cond is True:
            return ("not", _false_where_leaf(ast, resolve_table, kw))
        return cond

    ast.where = walk(ast.where)
    if ast.where is True:
        ast.where = None
    elif ast.where is False:
        ast.where = _false_where_leaf(ast, resolve_table, kw)

    for coll in (ast.items, [it for it, _ in ast.order_by]):
        for it in coll:
            if isinstance(getattr(it, "expr", None), VExpr):
                it.expr = _res_ve(it.expr)
            if isinstance(getattr(it, "col", None), VExpr):
                it.col = _res_ve(it.col)
            if it.kind == "case":
                it.branches = [(as_leaf(walk(cond)), val)
                               for cond, val in it.branches]


def _frame_row_codes(fr) -> np.ndarray:
    """(rows, cols) int64 row codes: per column, np.unique's inverse
    shifted by 1 with 0 reserved for NULL — equal rows (NULLs equal
    NULLs, the set-op convention) get equal code vectors without
    materializing Python row tuples."""
    codes = []
    for nm in fr.names:
        col = np.asarray(fr._columns[nm])
        try:
            _, inv = np.unique(col, return_inverse=True)
        except TypeError:
            # mixed-object column (e.g. exact ints next to None)
            _, inv = np.unique(col.astype(str), return_inverse=True)
        inv = inv.astype(np.int64) + 1
        ok = fr._ok[nm]
        if ok is not None:
            inv[~np.asarray(ok, bool)] = 0
        codes.append(inv)
    return np.stack(codes, axis=1)


def _slice_frame(fr, keep: np.ndarray):
    from .frame import Frame

    cols = {nm: np.asarray(fr._columns[nm])[keep] for nm in fr.names}
    oks = {nm: (None if fr._ok[nm] is None
                else np.asarray(fr._ok[nm], bool)[keep])
           for nm in fr.names}
    return Frame(list(fr.names), cols, oks, dict(fr.schema), len(keep))


@GLOBAL.span("sql.union_dedupe")
def _dedupe_frame(fr, device):
    """Row-level dedupe of a frame (plain UNION): first occurrence of
    each distinct row survives, in order; NULLs compare equal. Fully
    typed frames above the size floor dedupe ON DEVICE (one stable
    lexicographic sort + run detection, setops.dedupe_keep); the host
    row-code path handles text/mixed columns and stays the oracle."""
    if len(fr) == 0:
        return fr
    from .setops import dedupe_keep

    keep = dedupe_keep(fr, device)
    if keep is not None:
        return _slice_frame(fr, keep)
    _, first = np.unique(_frame_row_codes(fr), axis=0,
                         return_index=True)
    return _slice_frame(fr, np.sort(first))


@GLOBAL.span("sql.setop")
def _setop_frames(acc, other, op: str, device):
    """EXCEPT / INTERSECT: distinct rows of `acc` that are absent from
    / present in `other` (first occurrence kept, in order; NULLs equal
    NULLs). Row codes must be computed over BOTH frames' values at
    once so equal values share codes — _union_frames does the width/
    type validation and the value concatenation for free."""
    both = _union_frames([acc, other])
    if len(both) == 0:
        return both
    from .setops import setop_keep_concat

    keep_dev = setop_keep_concat(both, len(acc), op, device)
    if keep_dev is not None:
        return _slice_frame(both, keep_dev)
    codes = _frame_row_codes(both)
    na = len(acc)
    a, b = codes[:na], codes[na:]
    _, first = np.unique(a, axis=0, return_index=True) \
        if na else (None, np.zeros(0, np.int64))
    bset = {tuple(r) for r in b.tolist()}
    want_in = op == "intersect"
    keep = np.asarray(
        [i for i in np.sort(first)
         if (tuple(a[i].tolist()) in bset) == want_in],
        dtype=np.int64)
    return _slice_frame(both, keep)


def _as_frame(res):
    """A subquery result as a Frame source for the outer query.
    Plain selections already ARE Frames; an aggregate's SqlResult
    converts — int columns keep their exact Python ints in object
    arrays (sums past 2**53 never round), None/NaN cells become
    ok=False rows (NULL semantics carry through)."""
    from .frame import Col, Frame

    if not isinstance(res, SqlResult):
        return res
    cols, oks, schema = {}, {}, {}
    for nm in res.names:
        arr = np.asarray(res._columns[nm])
        t = res.schema[nm].type
        if t == "str":
            cols[nm] = arr
            oks[nm] = None
            schema[nm] = Col("str")
            continue
        vals = arr.tolist()
        ok = np.array(
            [v is not None and not (isinstance(v, float) and v != v)
             for v in vals], bool)
        if t == "float":
            cols[nm] = np.array(
                [float(v) if o else np.nan
                 for v, o in zip(vals, ok)], np.float64)
            schema[nm] = Col("float")
        else:
            # exact object ints; invalid cells hold 0 (masked off)
            cols[nm] = np.array(
                [int(v) if o else 0 for v, o in zip(vals, ok)],
                object)
            schema[nm] = Col("int32")
        oks[nm] = ok if not ok.all() else None
    return Frame(list(res.names), cols, oks, schema, len(res))


def _all_columns(src, kw) -> List[str]:
    from .corpus_api import CsvCorpus

    if isinstance(src, CsvCorpus):
        return list(src.header_names())
    from .frame import _resolve_tape

    _, names = _resolve_tape(src, kw["dialect"], kw["backend"],
                             kw["engine"], False, kw["device"])
    return list(names)


def _resolve_ordinals(ast: _Ast) -> None:
    """1-based ordinal references resolve to SELECT items in place:
    ORDER BY 2 orders by the second item (the previous behavior — a
    constant key that silently didn't sort — was a wrong-results
    trap); GROUP BY 1 groups by the first item's column/alias."""

    def _item_for(n, what):
        if not (1 <= n <= len(ast.items)):
            raise SqlError(
                f"{what} ordinal {n} is out of range "
                f"(1..{len(ast.items)} SELECT items)")
        it = ast.items[n - 1]
        if it.kind == "star":
            raise SqlError(
                f"{what} ordinal {n} refers to *; name a column")
        return it

    ast.order_by = [
        ((_item_for(it.expr.tree[1], "ORDER BY"), d)
         if (it.kind == "expr"
             and getattr(it.expr, "tree", (None,))[0] == "lit"
             and isinstance(it.expr.tree[1], int))
         else (it, d))
        for it, d in ast.order_by
    ]
    gb = []
    for k in ast.group_by:
        if isinstance(k, int):
            it = _item_for(k, "GROUP BY")
            if it.kind == "col":
                gb.append(it.col)
            elif it.alias:
                gb.append(it.alias)
            else:
                raise SqlError(
                    f"GROUP BY ordinal {k} refers to a computed item "
                    "with no alias — alias it (AS name)")
        else:
            gb.append(k)
    ast.group_by = gb


def _rewrite_alias_group_by(ast: _Ast) -> _Ast:
    """GROUP BY on the ALIAS of a computed SELECT item (expression,
    text function, CASE, COALESCE) rewrites to a derived table: the
    inner select projects `*` plus the computed items (WHERE stays
    inside — it filters pre-grouping either way), the outer groups by
    the now-plain alias columns. Plain-column GROUP BY keeps the
    direct device pushdown path untouched."""
    if not ast.group_by:
        return ast
    expr_kinds = ("expr", "fold", "case", "coalesce")
    by_alias = {it.alias: it for it in ast.items if it.alias}
    special = {k: by_alias[k] for k in ast.group_by
               if isinstance(k, str) and k in by_alias
               and by_alias[k].kind in expr_kinds}
    if not special:
        return ast
    if ast.join_table is not None:
        raise SqlError(
            "GROUP BY on a computed alias over a JOIN is not "
            "supported — wrap the join in a derived table "
            "(WITH / FROM (SELECT ...)) first"
        )
    inner = _Ast()
    inner.table = ast.table
    inner.table_alias = ast.table_alias
    inner.where = ast.where
    inner.items = [_Item("star")] + list(special.values())
    outer = _Ast()
    outer.table = ("subquery", (inner, None))
    outer.distinct = ast.distinct
    outer.group_by = list(ast.group_by)
    outer.having = ast.having
    outer.order_by = ast.order_by
    outer.limit, outer.offset = ast.limit, ast.offset

    def _as_col(it):
        if it.alias in special and it is special[it.alias]:
            return _Item("col", col=it.alias, alias=it.alias)
        return it

    outer.items = [_as_col(it) for it in ast.items]
    return outer


def _walk_statement_asts(node):
    """Yield every _Ast in a statement tree: union branches, derived
    tables on both FROM sides, and IN/EXISTS/scalar subquery inners
    (incl. inside CASE conditions)."""
    if isinstance(node, _Union):
        for b in node.branches:
            yield from _walk_statement_asts(b)
        return
    yield node
    for tbl in (node.table, node.join_table):
        if tbl is not None and tbl[0] == "subquery":
            yield from _walk_statement_asts(tbl[1][0])

    def walk_where(e):
        if isinstance(e, _InSubquery):
            yield from _walk_statement_asts(e.ast)
            return
        if isinstance(e, tuple):
            if len(e) == 3:
                if isinstance(e[2], _InSubquery):
                    yield from _walk_statement_asts(e[2].ast)
                return
            if len(e) == 2 and e[0] in ("and", "or"):
                for x in e[1]:
                    yield from walk_where(x)
                return
            if len(e) == 2 and e[0] == "not":
                yield from walk_where(e[1])
                return
            if len(e) == 2 and e[0] == "exists":
                yield from _walk_statement_asts(e[1].ast)
                return
        if isinstance(e, list):
            for x in e:
                yield from walk_where(x)

    if node.where is not None:
        yield from walk_where(node.where)
    for it in list(node.items) + [i for i, _d in node.order_by]:
        if getattr(it, "kind", None) == "case":
            for cond, _v in it.branches:
                yield from walk_where(cond)


def _refs_table(node, name: str) -> bool:
    """Does any FROM/JOIN in the statement reference table `name`?"""
    return any(
        tbl is not None and tbl[0] == "name" and tbl[1] == name
        for a in _walk_statement_asts(node)
        for tbl in (a.table, a.join_table)
    )


def _inject_ctes(node, ctes: Dict) -> None:
    """Rewrite every FROM/JOIN reference to a CTE name into a derived
    table carrying a DEEP COPY of the CTE body (each reference
    executes independently — execution mutates asts in place, so
    sharing one body object between sites would be unsound)."""
    if not ctes:
        return
    import copy

    for a in _walk_statement_asts(node):
        for attr in ("table", "join_table"):
            tbl = getattr(a, attr)
            if tbl is not None and tbl[0] == "name" and tbl[1] in ctes:
                setattr(a, attr, ("subquery",
                                  (copy.deepcopy(ctes[tbl[1]]),
                                   tbl[1])))


def _dequalify_ast(ast: _Ast, tname: str) -> None:
    """Strip 't.' qualifiers in place when t is the single FROM
    table's bare name (SELECT t.k FROM t is ordinary SQL)."""
    pre = tname + "."

    from .query import VExpr

    def deq(ref):
        if isinstance(ref, str) and ref.startswith(pre):
            return ref[len(pre):]
        if isinstance(ref, tuple) and len(ref) == 2:
            # CONCAT parts: ("col", name) / ("item", nested fold)
            if ref[0] == "col":
                return ("col", deq(ref[1]))
            if ref[0] == "item":
                return ("item", deq_item(ref[1]))
        return ref

    def deq_tree(t):
        if t[0] in ("col", "len"):
            return (t[0], deq(t[1]))
        if t[0] in ("neg", "abs", "floor", "ceil"):
            return (t[0], deq_tree(t[1]))
        if t[0] == "cast":
            return ("cast", deq_tree(t[1]), t[2])
        if t[0] == "lit":
            return t
        return (t[0], deq_tree(t[1]), deq_tree(t[2]))

    def deq_where(e):
        if e is None:
            return None
        if isinstance(e, tuple) and len(e) == 3 \
                and isinstance(e[1], str):
            if isinstance(e[0], VExpr):
                return (VExpr(deq_tree(e[0].tree)), e[1],
                        VExpr(deq_tree(e[2].tree))
                        if isinstance(e[2], VExpr) else e[2])
            from .query import TextFold
            if isinstance(e[0], TextFold):
                return (TextFold(e[0].fn, deq(e[0].col)), e[1], e[2])
            if e[1] == "in_rows" and isinstance(e[0], tuple):
                # composite semi-join key: dequalify every column
                return (tuple(deq(c) for c in e[0]), e[1], e[2])
            return (deq(e[0]), e[1], e[2])
        if isinstance(e, tuple) and len(e) == 2 \
                and e[0] in ("and", "or"):
            return (e[0], [deq_where(x) for x in e[1]])
        if isinstance(e, tuple) and len(e) == 2 and e[0] == "not":
            return ("not", deq_where(e[1]))
        if isinstance(e, list):
            return [deq_where(x) for x in e]
        return e

    def deq_item(it: _Item) -> _Item:
        it2 = _Item(it.kind, fn=it.fn, alias=it.alias,
                    distinct=it.distinct)
        if hasattr(it, "sep"):  # GROUP_CONCAT separator rides along
            it2.sep = it.sep
        if isinstance(it.col, tuple):
            it2.col = tuple(deq(c) for c in it.col)
        elif isinstance(it.col, VExpr):
            it2.col = VExpr(deq_tree(it.col.tree))
        else:
            it2.col = deq(it.col)
        if it.kind == "window":
            it2.part = [deq(c) for c in it.part]
            it2.worder = [(deq(c), d) for c, d in it.worder]
            it2.offset = it.offset
            it2.frame = getattr(it, "frame", None)
        if it.kind == "expr":
            it2.expr = VExpr(deq_tree(it.expr.tree))
        def deq_cval(spec):
            k, v = spec
            if k == "col":
                return (k, deq(v))
            if k == "expr":
                return (k, VExpr(deq_tree(v.tree)))
            return spec

        if it.kind == "case":
            it2.branches = [
                (deq_where(cond), deq_cval(val))
                for cond, val in it.branches
            ]
            ev = it.else_value
            it2.else_value = None if ev is None else deq_cval(ev)
        return it2

    ast.items = [it if it.kind == "star" else deq_item(it)
                 for it in ast.items]
    ast.group_by = [deq(k) for k in ast.group_by]
    ast.order_by = [(deq_item(it), d) for it, d in ast.order_by]
    ast.where = deq_where(ast.where)
    ast.having = deq_where(ast.having)  # 't.col.fn' -> 'col.fn'


def _run_select(ast: _Ast, src, kw):
    from .frame import read_typed

    if ast.having is not None:
        raise SqlError("HAVING needs GROUP BY")
    star_count = sum(1 for it in ast.items if it.kind == "star")
    pure_star = star_count == len(ast.items) and star_count > 0
    if star_count and not pure_star:
        # SELECT *, extra: expand the star into explicit column items
        items = []
        for it in ast.items:
            if it.kind == "star":
                items.extend(_Item("col", col=c)
                             for c in _all_columns(src, kw))
            else:
                items.append(it)
    else:
        items = ast.items
    has_computed = any(
        it.kind in ("coalesce", "case", "expr", "fold", "window")
        for it in items)
    for it in items:
        if it.kind == "agg":
            raise SqlError(
                f"aggregate {it.name()!r} needs GROUP BY (or no "
                "plain columns)"
            )
    # ORDER BY resolution: a key naming an output item orders by that
    # item (alias); a computed item needs host ordering after the
    # projection — a plain column (or a col-item alias) pushes down
    # to the device sort
    out_items = {} if pure_star else {it.name(): it for it in items}
    order_keys, order_desc = [], []
    host_order = []  # [(ref, desc)] — resolved against proj then fr;
    #                  an _Item ref is computed on demand (ORDER BY an
    #                  expression / UPPER()/LOWER() not in the SELECT)

    def _order_ref(it):
        if it.kind == "col":
            return it.col
        nm = it.name()
        return nm if nm in out_items else it

    for it, d in ast.order_by:
        if it.kind in ("expr", "fold"):
            host_order.append((_order_ref(it), d))
            continue
        if it.kind != "col":
            raise SqlError("ORDER BY aggregates needs GROUP BY")
        target = out_items.get(it.col)
        if target is not None and target.kind == "col":
            order_keys.append(target.col)
            order_desc.append(d)
        elif target is not None:
            host_order.append((it.col, d))
        else:
            order_keys.append(it.col)
            order_desc.append(d)
    if host_order and order_keys:
        # mixed device/host keys would not compose lexicographically:
        # move the WHOLE sort to host (refs resolve against the
        # projection first, then the source frame)
        host_order = [(_order_ref(it), d) for it, d in ast.order_by]
        order_keys = []
    if pure_star:
        cols = _all_columns(src, kw) if kw["schema"] else None
    else:
        # read the union of referenced columns (coalesce inputs, CASE
        # condition/value columns, host-order source columns)
        cols = []
        for it in items:
            for c in _item_input_cols(it):
                if c not in cols:
                    cols.append(c)
        for k, _d in host_order:
            if isinstance(k, _Item):
                for c in _item_input_cols(k):
                    if c not in cols:
                        cols.append(c)
            elif k not in out_items and k not in cols:
                cols.append(k)
    fetch = (None if (ast.limit is None or host_order)
             else ast.limit + ast.offset)
    fr = read_typed(
        src, kw["schema"], columns=cols, where=ast.where,
        order_by=(order_keys or None), descending=order_desc,
        limit=fetch,
        engine=kw["engine"], backend=kw["backend"],
        dialect=kw["dialect"], sample=kw["sample"],
        device=kw["device"],
    )
    proj = (fr if pure_star and not has_computed
            else _project_items(fr, items, lambda c: c, kw["device"]))
    if host_order:
        from .query import _host_multi_order_perm

        def _order_col(ref):
            if isinstance(ref, _Item):  # hidden computed order key
                if ref.kind == "fold":
                    vals, okm, _c = _fold_column(fr, ref, lambda c: c)
                else:
                    vals, okm, _c = _expr_column(fr, ref.expr,
                                                 lambda c: c)
                return vals, okm
            if ref in proj._columns:
                return proj._columns[ref], proj._ok[ref]
            return fr._columns[ref], fr._ok[ref]

        perm = _host_multi_order_perm(len(proj), _order_col, host_order)
        fr = fr.take(perm)
        proj = proj.take(perm) if proj is not fr else fr
    lo = min(ast.offset, len(proj))
    hi = (len(proj) if ast.limit is None
          else min(lo + ast.limit, len(proj)))
    if lo or hi < len(proj):
        proj = proj.take(np.arange(lo, hi))
    return proj


def _item_input_cols(it: _Item):
    """Every source column a SELECT item needs materialized."""
    from .query import _where_leaves

    if it.kind == "coalesce":
        return list(it.col)
    if it.kind == "window":
        out = list(it.part) + [c for c, _ in it.worder]
        if isinstance(it.col, str):
            out.append(it.col)
        elif it.col is not None:  # VExpr
            out.extend(it.col.columns())
        return out
    if it.kind == "fold":
        if it.fn in _TUPLE_FOLDS:
            return [it.col[0]]
        if it.fn == "concat":
            out = []
            for part in it.col:
                if part[0] == "col":
                    out.append(part[1])
                elif part[0] == "item":
                    out.extend(_item_input_cols(part[1]))
            return out
        return [it.col]
    if it.kind == "expr":
        return it.expr.columns()
    if it.kind == "case":
        out = []
        vals = [v for _, v in it.branches]
        if it.else_value is not None:
            vals.append(it.else_value)
        for cond, _ in it.branches:
            for leaf in _where_leaves(cond):
                if isinstance(leaf[0], str):
                    out.append(leaf[0])
                elif isinstance(leaf[0], tuple):
                    # composite in_rows key (multi-key correlated
                    # EXISTS rewritten inside a CASE WHEN)
                    out.extend(leaf[0])
                else:  # arithmetic WHEN condition
                    out.extend(leaf[0].columns())
                    if not isinstance(leaf[2], str) \
                            and hasattr(leaf[2], "columns"):
                        out.extend(leaf[2].columns())
        for k, v in vals:
            if k == "col":
                out.append(v)
            elif k == "expr":
                out.extend(v.columns())
        return out
    return [it.col]


def _expr_column(fr, vx, resolve):
    """Evaluate an arithmetic item over a materialized frame, with the
    SAME semantics as the device predicate evaluator (query._eval_vexpr):
    int math in int32 (two's-complement wrap), any float operand or
    division promotes to float32, x/0 and any not-ok operand make the
    row not-ok. Date columns participate as day numbers."""
    from .frame import parse_spec

    n = len(fr)

    def ev(t):
        k = t[0]
        if k == "lit":
            isf = isinstance(t[1], float)
            dt = np.float32 if isf else np.int32
            return (np.full(n, t[1], dt), np.ones(n, bool), isf)
        if k == "len":
            # LENGTH(col): decoded byte length (host twin of the device
            # leaf in query._eval_vexpr — frame text cells ARE the
            # decoded values, so len() of their bytes matches; str/bytes
            # columns only, same restriction as the device leaf)
            name = resolve(t[1])
            col = fr.schema[name]
            if col.type not in ("str", "bytes"):
                raise SqlError(
                    f"LENGTH needs a str/bytes column; {name!r} is "
                    f"{col.type} (give an explicit schema to keep it "
                    "text)"
                )
            vals = fr._columns[name]
            lens = np.fromiter(
                (len(v) if isinstance(v, (bytes, bytearray))
                 else len(str(v).encode()) for v in vals),
                np.int32, count=n)
            okm = fr._ok[name]
            ok = (np.ones(n, bool) if okm is None
                  else np.asarray(okm, bool))
            return lens, ok, False
        if k == "col":
            name = resolve(t[1])
            col = fr.schema[name]
            if col.type in ("str", "bytes"):
                raise SqlError(
                    f"column {name!r} is {col.type}: arithmetic needs "
                    "a numeric column"
                )
            if col.type in ("decimal", "datetime"):
                raise SqlError(
                    f"column {name!r} is {col.type}: decimal/datetime "
                    "columns are not supported in arithmetic "
                    "expressions"
                )
            vals = np.asarray(fr._columns[name])
            if vals.dtype.kind == "M":
                vals = vals.astype("datetime64[D]").astype(np.int64) \
                    .astype(np.int32)
            okm = fr._ok[name]
            ok = (np.ones(n, bool) if okm is None
                  else np.asarray(okm, bool))
            return vals, ok, vals.dtype.kind == "f"
        if k == "neg":
            v, ok, isf = ev(t[1])
            return -v, ok, isf
        if k == "abs":
            v, ok, isf = ev(t[1])
            return np.abs(v), ok, isf
        if k in ("floor", "ceil"):
            v, ok, isf = ev(t[1])
            if not isf:
                return v, ok, isf
            return (np.floor(v) if k == "floor" else np.ceil(v),
                    ok, isf)
        if k == "cast":
            v, ok, isf = ev(t[1])
            to_f = t[2] == "float"
            if to_f == isf:
                return v, ok, isf
            if to_f:
                return v.astype(np.float32), ok, True
            # float -> int32: truncate toward zero, SATURATE at the
            # int32 limits (as the device twin, query._cast_int32, and
            # XLA's convert do — np would wrap)
            with np.errstate(invalid="ignore"):
                t0 = np.clip(np.trunc(v.astype(np.float64)),
                             -2147483648.0, 2147483647.0)
                return t0.astype(np.int32), ok, False
        if k == "round":
            v, ok, isf = ev(t[1])
            d = int(t[2][1])
            if not isf and d >= 0:
                return v, ok, isf
            s = np.float32(10.0 ** d)
            # round-half-to-even, same as the device twin (torch.round)
            return (np.round(v.astype(np.float32) * s) / s, ok, True)
        va, oa, fa = ev(t[1])
        vb, ob, fb = ev(t[2])
        ok = oa & ob
        if k == "%":
            # truncated remainder (sign of the dividend), like the
            # device twin's torch.fmod; b == 0 -> row not-ok
            isf = fa or fb
            if isf:
                va = va.astype(np.float32)
                vb = vb.astype(np.float32)
            ok = ok & (vb != 0)
            safe = np.where(vb == 0, vb.dtype.type(1), vb)
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.fmod(va, safe), ok, isf
        isf = fa or fb or k == "/"
        if isf:
            va, vb = va.astype(np.float32), vb.astype(np.float32)
        if k == "+":
            return va + vb, ok, isf
        if k == "-":
            return va - vb, ok, isf
        if k == "*":
            return va * vb, ok, isf
        ok = ok & (vb != 0)
        with np.errstate(divide="ignore", invalid="ignore"):
            return va / np.where(vb == 0, np.float32(1), vb), ok, isf

    vals, ok, isf = ev(vx.tree)
    okm = None if ok.all() else ok
    return vals, okm, parse_spec("float" if isf else "int32")


def _coalesce_column(fr, cols):
    """First non-NULL value per row across same-typed columns."""
    base = fr.schema[cols[0]]
    for c in cols[1:]:
        if fr.schema[c].type != base.type:
            raise SqlError(
                f"COALESCE column types disagree: {cols[0]!r} is "
                f"{base.type!r}, {c!r} is {fr.schema[c].type!r}"
            )
    n = len(fr)
    vals = np.array(fr._columns[cols[0]], copy=True)
    got = np.zeros(n, bool)
    for c in cols:
        okm = fr._ok[c]
        ok = np.ones(n, bool) if okm is None else np.asarray(okm, bool)
        take = ok & ~got
        vals[take] = np.asarray(fr._columns[c])[take]
        got |= ok
    okm = got if not got.all() else None
    return vals, okm, base


def _case_column(fr, it, resolve):
    """Evaluate a CASE item over a materialized frame: first matching
    WHEN branch wins; no match and no ELSE -> NULL (ok=False). THEN/
    ELSE values are literals (numbers -> float column, any string ->
    text), same-typed column refs, arithmetic EXPRESSIONS (numeric:
    the result is float32 if any value is float/division else int32),
    or a literal/column/expression mix in the numeric cases."""
    from .frame import Col

    from .query import _typed_literal

    n = len(fr)
    vals_spec = [v for _, v in it.branches]
    if it.else_value is not None:
        vals_spec.append(it.else_value)
    col_refs = [resolve(v) for k, v in vals_spec if k == "col"]
    lits = [v for k, v in vals_spec if k == "lit"]
    exprs = [v for k, v in vals_spec if k == "expr"]
    if exprs:
        # expression values: a numeric CASE — every value must be
        # numeric; float32 if anything is float, else int32
        if any(isinstance(x, str) for x in lits):
            raise SqlError(
                "CASE mixing expression values with string literals"
            )
        ev = {}
        isf = False
        for vx in exprs:
            vals, okm, c = _expr_column(fr, vx, resolve)
            ev[id(vx)] = (np.asarray(vals), okm)
            isf |= c.type in ("float", "float32")
        for c in col_refs:
            t = fr.schema[c].type
            if t not in ("int32", "float", "float32"):
                raise SqlError(
                    "CASE with expression values needs numeric "
                    f"columns; {c!r} is {t!r}"
                )
            isf |= t in ("float", "float32")
        isf |= any(isinstance(x, float) for x in lits)
        from .frame import parse_spec

        dt = np.float32 if isf else np.int32
        out = np.zeros(n, dt)
        col = parse_spec("float" if isf else "int32")
        ok = np.zeros(n, bool)
        assigned = np.zeros(n, bool)

        def _valuex(spec, rows):
            kind, v = spec
            if kind == "lit":
                return dt(v), None
            if kind == "expr":
                vals, okm = ev[id(v)]
                return (vals[rows].astype(dt),
                        None if okm is None
                        else np.asarray(okm, bool)[rows])
            srcn = resolve(v)
            okm = fr._ok[srcn]
            return (np.asarray(fr._columns[srcn])[rows].astype(dt),
                    None if okm is None else np.asarray(okm, bool)[rows])

        for cond, vspec in it.branches:
            m = _frame_mask(fr, cond, resolve) & ~assigned
            rows = np.flatnonzero(m)
            if rows.size:
                v, vok = _valuex(vspec, rows)
                out[rows] = v
                ok[rows] = True if vok is None else vok
            assigned |= m
        if it.else_value is not None:
            rows = np.flatnonzero(~assigned)
            if rows.size:
                v, vok = _valuex(it.else_value, rows)
                out[rows] = v
                ok[rows] = True if vok is None else vok
        okm = ok if not ok.all() else None
        return out, okm, col
    if col_refs:
        base = fr.schema[col_refs[0]]
        for c in col_refs[1:]:
            if fr.schema[c].type != base.type:
                raise SqlError(
                    "CASE column values must share one type: "
                    f"{col_refs[0]!r} is {base.type!r}, {c!r} is "
                    f"{fr.schema[c].type!r}"
                )
        text = base.type in ("str", "bytes")
        if text and any(not isinstance(x, str) for x in lits):
            raise SqlError(
                "CASE literals for a text column must be strings"
            )
        out = np.array(fr._columns[col_refs[0]], copy=True)
        col = base
    else:
        text = any(isinstance(x, str) for x in lits)
        out = (np.empty(n, object) if text
               else np.zeros(n, np.float64))
        col = Col("str") if text else Col("float")
        base = None
        if text:
            out[:] = ""
    ok = np.zeros(n, bool)
    assigned = np.zeros(n, bool)

    def _value(spec, rows):
        kind, v = spec
        if kind == "lit":
            if base is None:
                return (str(v) if text else np.float64(v)), None
            # literal in a column-typed CASE: convert to the column's
            # value domain (scaled decimal, epoch, int32 ...)
            return ((str(v) if text else _typed_literal(base, v)),
                    None)
        srcn = resolve(v)
        okm = fr._ok[srcn]
        return (np.asarray(fr._columns[srcn])[rows],
                None if okm is None else np.asarray(okm, bool)[rows])

    for cond, vspec in it.branches:
        m = _frame_mask(fr, cond, resolve) & ~assigned
        rows = np.flatnonzero(m)
        if rows.size:
            v, vok = _value(vspec, rows)
            out[rows] = v
            ok[rows] = True if vok is None else vok
        assigned |= m
    if it.else_value is not None:
        rows = np.flatnonzero(~assigned)
        if rows.size:
            v, vok = _value(it.else_value, rows)
            out[rows] = v
            ok[rows] = True if vok is None else vok
        assigned[:] = True
    okm = ok if not ok.all() else None
    return out, okm, col


def _text_source(fr, ref, resolve, what):
    """Resolve + decode a text column to a list of str (host pass)."""
    srcn = resolve(ref)
    col = fr.schema[srcn]
    if col.type not in ("str", "bytes"):
        raise SqlError(
            f"{what} fold decoded text; {ref!r} is "
            f"{col.type} (give an explicit str/bytes schema)"
        )
    strs = [v if isinstance(v, str)
            else bytes(v).decode("utf-8", "surrogateescape")
            for v in fr._columns[srcn]]
    return strs, fr._ok[srcn], col


def _fold_column(fr, it: _Item, resolve):
    """SELECT text-function items (UPPER/LOWER/TRIM/LTRIM/RTRIM/
    SUBSTR/CONCAT): the values are already on host (every plain
    selection materializes), so these are host passes over the
    decoded strings — UPPER/LOWER keep the same ASCII-only semantics
    as the device predicate fold (query._fold_device); TRIM strips
    ASCII spaces (SQL's default); SUBSTR is 1-based."""
    fn = it.fn
    if fn == "concat":
        n = len(fr)
        cols_vals, ok = [], None
        spec = None
        for part in it.col:
            if part[0] == "lit":
                cols_vals.append(part[1])
                continue
            if part[0] == "col":
                strs, okm, c = _text_source(fr, part[1], resolve,
                                            "CONCAT()")
            else:  # ("item", nested fold)
                vals, okm, c = _fold_column(fr, part[1], resolve)
                strs = list(vals)
            cols_vals.append(strs)
            spec = spec or c
            if okm is not None:
                m = np.asarray(okm, bool)
                ok = m.copy() if ok is None else (ok & m)
        out = np.array(
            ["".join(p if isinstance(p, str) else p[i]
                     for p in cols_vals) for i in range(n)], object)
        return out, ok, spec
    ref = it.col[0] if fn in _TUPLE_FOLDS else it.col
    strs, okm, col = _text_source(fr, ref, resolve,
                                  f"{fn.upper()}()")
    if fn == "instr":
        # 1-based position of the first occurrence, 0 when absent
        # (SQLite semantics; INSTR(col, '') is 1): an INT column
        from .frame import Col

        _, sub = it.col
        vals = [s.find(sub) + 1 for s in strs]
        return np.array(vals, np.int64), okm, Col("int32")
    if fn in ("upper", "lower"):
        vals = [_ascii_fold(s, fn) for s in strs]
    elif fn == "trim":
        vals = [s.strip(" ") for s in strs]
    elif fn == "ltrim":
        vals = [s.lstrip(" ") for s in strs]
    elif fn == "rtrim":
        vals = [s.rstrip(" ") for s in strs]
    elif fn == "replace":
        # REPLACE(col, '', x) returns the text unchanged (SQLite),
        # unlike Python's str.replace
        _, frm, to = it.col
        vals = [s.replace(frm, to) if frm else s for s in strs]
    else:  # substr, 1-based start
        _, start, length = it.col
        lo = start - 1
        hi = None if length is None else lo + length
        vals = [s[lo:hi] for s in strs]
    return np.array(vals, object), okm, col


def _device_window_column(fr, it, fn, n, part_cols, order_refs, vals,
                          okm, vspec, is_int, device, dev=None):
    """Device window execution (window.window_column): ONE device
    lexicographic sort + segmented scans instead of the host Python
    row loop. Returns the (vals, ok, Col) triple in the host
    executor's exact contract, or None when ineligible (small frames,
    float sums, >=2**20-row partitions, non-factorizable keys) — the
    host pass below is the fallback AND the differential oracle
    (tests/test_sql_window_device.py)."""
    from .frame import Col
    from .query import VExpr
    from .window import window_column

    # key entries carry the device-resident parse handle when
    # read_typed kept one (Frame._dev): window.factorize_key_device
    # then builds the sort codes ON DEVICE, moving O(1) scalars instead
    # of round-tripping the column through host np (VERDICT r4 item 3)
    devs = getattr(fr, "_dev", {})
    part_arrays = [(fr._columns[c], fr._ok[c], devs.get(c))
                   for c in part_cols]
    order_arrays = [(fr._columns[c], fr._ok[c], d, devs.get(c))
                    for c, d in order_refs]
    # one cache dict per OVER clause per frame: every window item over
    # the same (PARTITION BY, ORDER BY) shares the key factorization
    # and the single device sort
    try:
        caches = fr.__dict__.setdefault("_window_prep_cache", {})
        cache = caches.setdefault(
            (tuple(part_cols), tuple(order_refs)), {})
    except (AttributeError, TypeError):
        cache = None
    res = window_column(
        fn, n, part_arrays, order_arrays, vals, okm,
        offset=getattr(it, "offset", 1) or 1, is_int=is_int,
        cache=cache, frame=getattr(it, "frame", None), dev=dev,
        device=device,
    )
    if res is None:
        return None
    kind, payload = res
    if kind == "int":
        return payload, None, Col("int32")
    if kind == "float":
        return payload, None, Col("float")
    if kind == "sum":
        sums, okb = payload
        out = sums.astype(object)
        out[~okb] = None
        return out, (None if okb.all() else okb), Col("int32")
    if kind in ("mean", "fsum"):
        means, okb = payload
        means = means.copy()
        means[~okb] = np.nan
        return means, (None if okb.all() else okb), Col("float")
    if kind == "minmax":
        valsb, okb = payload
        out = valsb.astype(object)
        out[~okb] = None
        return out, (None if okb.all() else okb), vspec
    # kind == "src": lag/lead — gather source values on host (works for
    # every column type; the device computed partition-bounded indices)
    src = payload
    out = np.empty(n, object)
    okb = src >= 0
    if okm is not None:
        okb = okb & np.where(src >= 0, np.asarray(okm, bool)[
            np.clip(src, 0, n - 1)], False)
    out[~okb] = None
    sel = np.flatnonzero(okb)
    out[sel] = np.asarray(vals, object)[src[sel]]
    return out, (None if okb.all() else okb), vspec


@GLOBAL.span("sql.window")
def _window_column(fr, it: _Item, resolve, device):
    """Evaluate a window item over a materialized frame (the values
    are on host — plain selections materialize — so windows are host
    passes, like the text functions). Semantics follow standard SQL:
    rows keep their original order; the window orders internally by
    PARTITION keys then the OVER ORDER BY keys (stable, NULLs last);
    aggregates with an ORDER BY use the default RANGE UNBOUNDED
    PRECEDING frame (peer rows — equal order keys — share the value),
    without one they cover the whole partition; LAG/LEAD step over
    ROWS within the partition; COUNT/SUM/AVG/MIN/MAX skip NULLs."""
    from .frame import Col

    from .query import VExpr, _host_multi_order_perm

    n = len(fr)
    part_cols = [resolve(c) for c in it.part]
    order_refs = [(resolve(c), d) for c, d in it.worder]

    vals = okm = vspec = None
    dev_handle = None
    if it.col is not None:
        if isinstance(it.col, VExpr):
            vals, okm, vspec = _expr_column(fr, it.col, resolve)
        else:
            src = resolve(it.col)
            vals, okm, vspec = (np.asarray(fr._columns[src]),
                                fr._ok[src], fr.schema[src])
            dev_handle = getattr(fr, "_dev", {}).get(src)
    numeric = vspec is not None and vspec.type in ("int32", "float",
                                                   "float32")
    is_int = vspec is not None and vspec.type == "int32"
    fn = it.fn
    if fn in ("sum", "mean") and not numeric:
        raise SqlError(
            f"{('AVG' if fn == 'mean' else 'SUM')}() OVER needs a "
            f"numeric column, got {vspec.type if vspec else None!r}"
        )

    dev = _device_window_column(fr, it, fn, n, part_cols, order_refs,
                                vals, okm, vspec, is_int, device,
                                dev=dev_handle)
    if dev is not None:
        return dev

    def _colpair(ref):
        return fr._columns[ref], fr._ok[ref]

    sort_keys = [(c, False) for c in part_cols] + list(order_refs)
    perm = (_host_multi_order_perm(n, _colpair, sort_keys)
            if sort_keys else np.arange(n, dtype=np.int64))

    def _tuples(refs):
        if not refs:
            return [()] * n
        arrs = [(np.asarray(fr._columns[c]), fr._ok[c]) for c in refs]
        return [tuple((None if (ok is not None and not ok[i])
                       else _pykey(a[i])) for a, ok in arrs)
                for i in range(n)]

    ptup = _tuples(part_cols)
    otup = _tuples([c for c, _ in order_refs])

    def _ok_at(i):
        return okm is None or bool(okm[i])

    # rows of each partition, in window order
    parts: Dict[tuple, List[int]] = {}
    for i in perm.tolist():
        parts.setdefault(ptup[i], []).append(i)

    out = np.empty(n, object)
    ok_out = np.ones(n, bool)
    wframe = getattr(it, "frame", None)

    def _fill_rows_frame(rows):
        """Explicit ROWS frame over one partition: per-row [lo, hi]
        row-offset windows (None = unbounded side), NULLs skipped.
        sum/count/mean ride prefix arrays (exact Python ints);
        unbounded-side min/max ride prefix/suffix extrema; doubly
        bounded min/max scan their (user-sized) window."""
        _k, lo_off, hi_off = wframe
        L = len(rows)
        oks = [(it.col is None) or _ok_at(i) for i in rows]
        pc = [0]
        for p in range(L):
            pc.append(pc[p] + (1 if oks[p] else 0))
        ps = pref = suf = None
        if fn in ("sum", "mean"):
            ps = [0]
            for p, i in enumerate(rows):
                v = ((int(vals[i]) if is_int else float(vals[i]))
                     if oks[p] else 0)
                ps.append(ps[p] + v)
        red = min if fn == "min" else max
        if fn in ("min", "max") and lo_off is None:
            pref, cur = [], None
            for p, i in enumerate(rows):
                if oks[p]:
                    cur = vals[i] if cur is None else red(cur, vals[i])
                pref.append(cur)
        if fn in ("min", "max") and lo_off is not None \
                and hi_off is None:
            suf, cur = [None] * L, None
            for p in range(L - 1, -1, -1):
                if oks[p]:
                    v = vals[rows[p]]
                    cur = v if cur is None else red(cur, v)
                suf[p] = cur
        for p, i in enumerate(rows):
            lo = 0 if lo_off is None else max(0, p + lo_off)
            hi = L - 1 if hi_off is None else min(L - 1, p + hi_off)
            c = 0 if lo > hi else pc[hi + 1] - pc[lo]
            if fn == "count":
                out[i] = c
                continue
            if c == 0:
                out[i] = None
                ok_out[i] = False
                continue
            if fn in ("sum", "mean"):
                s = ps[hi + 1] - ps[lo]
                out[i] = s if fn == "sum" else s / c
            elif lo_off is None:
                out[i] = pref[hi]
            elif hi_off is None:
                out[i] = suf[lo]
            else:
                sel = [vals[rows[p2]] for p2 in range(lo, hi + 1)
                       if oks[p2]]
                out[i] = red(sel)

    for rows in parts.values():
        if fn == "row_number":
            for k, i in enumerate(rows):
                out[i] = k + 1
            continue
        if fn in ("lag", "lead"):
            off = it.offset if fn == "lead" else -it.offset
            for k, i in enumerate(rows):
                j = k + off
                if 0 <= j < len(rows) and _ok_at(rows[j]):
                    out[i] = vals[rows[j]]
                else:
                    out[i] = None
                    ok_out[i] = False
            continue
        if fn == "ntile":
            # SQL NTILE: L rows into nt buckets, the first L % nt
            # buckets one row larger
            L, nt = len(rows), it.offset
            small, rem = L // nt, L % nt
            cut = rem * (small + 1)
            for p, i in enumerate(rows):
                out[i] = (p // (small + 1) + 1 if p < cut
                          else rem + (p - cut) // max(small, 1) + 1)
            continue
        if fn in ("first_value", "last_value", "nth_value"):
            # value AT a frame position — NULLs are NOT skipped (SQL:
            # these return the value of that row, null or not); the
            # default frame starts at the partition and ends at the
            # current PEER group's last row (peer sharing)
            L = len(rows)
            if wframe is None:
                ends = [0] * L
                for p in range(L - 1, -1, -1):
                    ends[p] = (p if p == L - 1
                               or otup[rows[p]] != otup[rows[p + 1]]
                               else ends[p + 1])
                los = [0] * L
            else:
                _k, lo_off, hi_off = wframe
                los = [0 if lo_off is None else max(0, p + lo_off)
                       for p in range(L)]
                ends = [L - 1 if hi_off is None
                        else min(L - 1, p + hi_off) for p in range(L)]
            for p, i in enumerate(rows):
                lo, hi = los[p], ends[p]
                if fn == "first_value":
                    pos = lo
                elif fn == "last_value":
                    pos = hi
                else:
                    pos = lo + it.offset - 1
                if lo > hi or pos > hi or pos < lo \
                        or not _ok_at(rows[pos]):
                    out[i] = None
                    ok_out[i] = False
                else:
                    out[i] = vals[rows[pos]]
            continue
        if wframe is not None and fn in ("count", "sum", "mean",
                                         "min", "max"):
            _fill_rows_frame(rows)
            continue
        # peer groups: runs of equal OVER-ORDER-BY keys (the whole
        # partition is one peer group when there is no ORDER BY)
        groups: List[List[int]] = []
        for i in rows:
            if groups and otup[i] == otup[groups[-1][0]]:
                groups[-1].append(i)
            else:
                groups.append([i])
        if fn in ("rank", "dense_rank", "percent_rank", "cume_dist"):
            seen_rows = 0
            size = len(rows)
            for gi, grp in enumerate(groups):
                if fn == "dense_rank":
                    r = gi + 1
                elif fn == "rank":
                    r = seen_rows + 1
                elif fn == "percent_rank":
                    r = (seen_rows / (size - 1)) if size > 1 else 0.0
                else:  # cume_dist: peers through this group / size
                    r = (seen_rows + len(grp)) / size
                for i in grp:
                    out[i] = r
                seen_rows += len(grp)
            continue
        cumulative = bool(order_refs)
        if not cumulative:
            groups = [rows]  # one frame covering the partition
        acc_cnt, acc_sum, acc_min, acc_max = 0, 0, None, None
        for grp in groups:
            for i in grp:
                if it.col is not None and not _ok_at(i):
                    continue
                if fn == "count":
                    acc_cnt += 1
                    continue
                v = vals[i]
                if fn in ("sum", "mean"):
                    acc_cnt += 1
                    acc_sum += int(v) if is_int else float(v)
                elif fn == "min":
                    acc_min = v if acc_min is None \
                        else min(acc_min, v)
                elif fn == "max":
                    acc_max = v if acc_max is None \
                        else max(acc_max, v)
            for i in grp:
                if fn == "count":
                    out[i] = acc_cnt
                elif fn == "sum":
                    out[i] = acc_sum if acc_cnt else None
                    ok_out[i] = bool(acc_cnt)
                elif fn == "mean":
                    out[i] = (acc_sum / acc_cnt) if acc_cnt else None
                    ok_out[i] = bool(acc_cnt)
                elif fn == "min":
                    out[i] = acc_min
                    ok_out[i] = acc_min is not None
                else:
                    out[i] = acc_max
                    ok_out[i] = acc_max is not None
    ok_final = None if ok_out.all() else ok_out
    if fn in ("row_number", "rank", "dense_rank", "count", "ntile"):
        return (np.array([int(v) for v in out], np.int64), None,
                Col("int32"))
    if fn in ("percent_rank", "cume_dist"):
        return (np.array([float(v) for v in out], np.float64), None,
                Col("float"))
    if fn == "mean":
        arr = np.array([np.nan if v is None else v for v in out],
                       np.float64)
        return arr, ok_final, Col("float")
    if fn == "sum":
        if is_int:
            return out, ok_final, Col("int32")  # exact Python ints
        arr = np.array([np.nan if v is None else v for v in out],
                       np.float64)
        return arr, ok_final, Col("float")
    # min/max/lag/lead carry source values
    return out, ok_final, vspec


def _project_items(fr, items, resolve, device):
    """Project a materialized frame onto SELECT items (cols +
    coalesce), applying aliases."""
    from .frame import Frame

    names, cols_out, oks_out, schema_out = [], {}, {}, {}
    for it in items:
        if it.kind == "case":
            vals, okm, col = _case_column(fr, it, resolve)
            nm = it.alias or "case"
        elif it.kind == "expr":
            vals, okm, col = _expr_column(fr, it.expr, resolve)
            nm = it.name()
        elif it.kind == "coalesce":
            srcs = [resolve(c) for c in it.col]
            vals, okm, col = _coalesce_column(fr, srcs)
            nm = it.alias or "coalesce"
        elif it.kind == "fold":
            vals, okm, col = _fold_column(fr, it, resolve)
            nm = it.name()
        elif it.kind == "window":
            vals, okm, col = _window_column(fr, it, resolve, device)
            nm = it.name()
        elif it.kind == "col":
            srcn = resolve(it.col)
            vals, okm, col = (fr._columns[srcn], fr._ok[srcn],
                              fr.schema[srcn])
            nm = it.alias or srcn
        else:
            raise SqlError(
                f"item {it.name()!r} is not valid in a plain selection"
            )
        if nm in cols_out:
            raise SqlError(f"duplicate output column {nm!r} (use AS)")
        names.append(nm)
        cols_out[nm], oks_out[nm], schema_out[nm] = vals, okm, col
    out = Frame(names, cols_out, oks_out, schema_out, len(fr))
    out.records = fr.records
    return out


def _rename(fr, mapping: Dict[str, str]):
    from .frame import Frame

    names = [mapping.get(n, n) for n in fr.names]
    if len(set(names)) != len(names):
        raise SqlError(f"duplicate output names after AS: {names}")
    out = Frame(
        names,
        {mapping.get(n, n): fr._columns[n] for n in fr.names},
        {mapping.get(n, n): fr._ok[n] for n in fr.names},
        {mapping.get(n, n): fr.schema[n] for n in fr.names},
        fr.num_records,
    )
    out.records = fr.records
    return out


def _order_group_rows(columns, order, n: int):
    """Stable multi-key host sort of n result rows; object-int columns
    compare exactly (Python ints). None aggregates (groups whose
    per-value count is 0) and NaN means sort LAST in both
    directions, like the row-level parse-failure convention."""
    idx = list(range(n))
    for key_name, desc in reversed(order):
        col = columns[key_name]
        nf = getattr(desc, "nulls_first", False)

        def _isnull(v):
            return v is None or (isinstance(v, float) and v != v)

        idx.sort(key=lambda i: 0 if _isnull(col[i]) else col[i],
                 reverse=bool(desc))
        # stable: nulls last (first under an explicit NULLS FIRST)
        idx.sort(key=lambda i: _isnull(col[i]) ^ nf)
    return np.asarray(idx, np.int64)


def _group_concat_column(src, keys, it: _Item, ast, kw, g):
    """GROUP_CONCAT(col [, sep]) / STRING_AGG: per-group concatenation
    of the column's non-NULL values in RECORD ORDER (SQLite's arrival
    semantics), separator default ','. One host pass over the
    (filtered) rows — text assembly is inherently host work, like the
    CSV writer. All-NULL groups yield SQL NULL."""
    from .frame import read_typed

    cols = list(keys) + ([it.col] if it.col not in keys else [])
    fr = read_typed(
        src, kw["schema"], columns=cols, where=ast.where,
        engine=kw["engine"], backend=kw["backend"],
        dialect=kw["dialect"], sample=kw["sample"],
        device=kw["device"],
    )
    gkeys = g["keys"] if isinstance(g["keys"], list) else [g["keys"]]
    gmap = {}
    for gi in range(int(np.asarray(g["count"]).shape[0])):
        gmap[tuple(_pykey(np.asarray(a)[gi]) for a in gkeys)] = gi
    parts: Dict[int, list] = {}
    karrs = [(np.asarray(fr._columns[k]), fr._ok.get(k)) for k in keys]
    vvals = np.asarray(fr._columns[it.col])
    vok = fr._ok.get(it.col)
    for i in range(len(fr)):
        if vok is not None and not vok[i]:
            continue  # NULL values are skipped (SQL)
        t = tuple(None if (ok is not None and not ok[i])
                  else _pykey(a[i]) for a, ok in karrs)
        gi = gmap.get(t)
        if gi is None:
            continue  # NULL-keyed rows form no group (layer semantics)
        v = vvals[i]
        parts.setdefault(gi, []).append(
            v if isinstance(v, str)
            else v.decode("utf-8", "surrogateescape")
            if isinstance(v, (bytes, np.bytes_)) else str(v))
    sep = getattr(it, "sep", ",")
    return np.array(
        [sep.join(parts[gi]) if gi in parts else None
         for gi in range(int(np.asarray(g["count"]).shape[0]))],
        object)


def _agg_array(g_aggs, col: str, fn: str):
    """One aggregate column of a group result. Groups where every value
    failed its typed parse (per-column count 0) have sentinel
    aggregates in the raw dict; surface SQL-NULL-style None (sum/min/
    max, object arrays) or NaN (mean) instead — consistent with
    HAVING, whose leaves already treat those groups as never
    matching."""
    cnt = np.asarray(g_aggs[col]["count"])
    if fn == "count":
        return cnt, "int64"
    if fn == "mean":
        s = g_aggs[col]["sum"]
        return (np.array([
            float(a) / int(b) if b else np.nan for a, b in zip(s, cnt)
        ]), "float")
    arr = np.asarray(g_aggs[col][fn])
    # device-path float aggregates come back float32, host-path
    # float64 — both are "float" outputs; object arrays hold exact
    # Python ints (int64) or text min/max values (str)
    t = "float" if arr.dtype.kind == "f" else "int64"
    if arr.dtype.kind == "O" and any(
            isinstance(v, str) for v in arr.tolist()):
        t = "str"
    if (cnt == 0).any():
        arr = np.array([v if c else None
                        for v, c in zip(arr.tolist(), cnt)], object)
    return arr, t


def _maybe_expr_ref(col: str):
    """A HAVING target's column part may be the canonical text of an
    expression aggregate (e.g. '(qty * price)' from
    HAVING SUM(qty*price) > 50 with no matching SELECT item): re-parse
    it back into a VExpr — the canonical text round-trips exactly, so
    the aggs-dict key it produces matches the having target."""
    if not any(ch in col for ch in "+-*/%("):
        return col
    try:
        p = _Parser(col)
        t = p._vexpr()
        p.expect("end")
    except SqlError:
        return col
    if t[0] == "col":
        return col
    from .query import VExpr

    return VExpr(t)


def _run_groupby(ast: _Ast, src, kw):
    from .query import groupby_typed

    keys = ast.group_by or [it.col for it in ast.items
                            if it.kind == "col"]
    if not keys:
        raise SqlError("SELECT DISTINCT needs column names")
    for it in ast.items:
        if it.kind == "star":
            raise SqlError("SELECT * cannot combine with GROUP BY")
        if it.kind == "expr":
            raise SqlError(
                "arithmetic expressions cannot appear alongside "
                "GROUP BY (aggregate them, or select them without "
                "GROUP BY)"
            )
        if it.kind == "fold":
            raise SqlError(
                "text-function items cannot combine with GROUP BY "
                "(select them without GROUP BY)"
            )
        if it.kind == "window":
            raise SqlError(
                "window functions cannot combine with GROUP BY "
                "(wrap the grouped select in a derived table)"
            )
        if it.kind == "col" and it.col not in keys:
            raise SqlError(
                f"column {it.col!r} must appear in GROUP BY or inside "
                "an aggregate"
            )
    from .query import VExpr

    plan = _device_topk_plan(ast, keys, src, kw)
    if plan is not None:
        from .query import groupby_topk

        sch = kw["schema"] or {}
        values, distinct, order = plan
        lim = None if ast.limit is None else ast.limit + ast.offset
        g = groupby_topk(
            src, keys if len(keys) > 1 else keys[0],
            key_spec=([sch.get(k) for k in keys] if len(keys) > 1
                      else sch.get(keys[0])),
            values=values, value_specs=[sch.get(v) for v in values],
            distinct=distinct, distinct_specs=[sch.get(c) for c in distinct],
            order=order, limit=lim, where=ast.where, schema=kw["schema"],
            engine=kw["engine"], backend=kw["backend"],
            dialect=kw["dialect"], sample=kw["sample"],
            device=kw["device"],
        )
        return _groups_to_result(ast, keys, g, src=src, kw=kw)

    def _vkey(c):
        return c if isinstance(c, str) else str(c)

    agg_items = [it for it in ast.items if it.kind == "agg"]
    # TEXT aggregate columns route through a pair group-by (see
    # _text_aggs_per_group) instead of the numeric device reduces
    tcols: set = set()

    def _mark_text(it: _Item) -> None:
        if (it.kind != "agg" or it.distinct
                or it.fn == "group_concat"
                or not isinstance(it.col, str)
                or it.col in tcols):
            return
        if _sql_col_type(src, it.col, kw) in ("str", "bytes"):
            if it.fn not in ("min", "max", "count"):
                raise SqlError(
                    f"{it.fn.upper()}() over text column {it.col!r} — "
                    "text aggregates are MIN/MAX/COUNT"
                )
            tcols.add(it.col)

    for it in agg_items:
        _mark_text(it)
    for it, _ in ast.order_by:
        _mark_text(it)
    value_cols: List[object] = []
    seen = set()
    for it in agg_items:
        if (it.col is not None and not it.distinct
                and it.fn != "group_concat"
                and _vkey(it.col) not in seen
                and _vkey(it.col) not in tcols):
            seen.add(_vkey(it.col))
            value_cols.append(it.col)
    for expr in (ast.having,):
        for col in _having_cols(expr):
            if col not in seen:
                seen.add(col)
                value_cols.append(_maybe_expr_ref(col))
    for it, _ in ast.order_by:
        if (it.kind == "agg" and it.col is not None
                and not it.distinct and _vkey(it.col) not in seen
                and _vkey(it.col) not in tcols):
            seen.add(_vkey(it.col))
            value_cols.append(it.col)
    # groupby_typed needs >= 1 value column; COUNT(*)/DISTINCT use
    # none, so ride the first key with a forced numeric spec — the
    # (unused) value aggregates just come back not-ok, while the group
    # keys and per-group row counts are value-independent
    probe_only = not value_cols
    sch = kw["schema"] or {}
    key_spec = [sch.get(k) for k in keys]
    if probe_only:
        # force a FLOAT probe spec: the probe's value aggregates are
        # never read, and a float value also sidesteps the integer
        # sum-exactness ceiling (COUNT(*) group-bys must work on
        # >2^20-row groups)
        value_cols = [keys[0]]
        value_spec = ["float"]
    else:
        # a VExpr value's "spec" is the schema entries of its
        # referenced columns (locks their types for the evaluation)
        value_spec = [
            ({r: sch[r] for r in v.columns() if r in sch} or None)
            if isinstance(v, VExpr) else sch.get(v)
            for v in value_cols
        ]
    g = groupby_typed(
        src, keys if len(keys) > 1 else keys[0], value_cols,
        key_spec=(key_spec if len(keys) > 1 else key_spec[0]),
        value_spec=value_spec, where=ast.where, having=ast.having,
        schema=kw["schema"],
        engine=kw["engine"], backend=kw["backend"],
        dialect=kw["dialect"], sample=kw["sample"],
        device=kw["device"],
    )
    for c in tcols:
        g["aggs"][c] = _text_aggs_per_group(src, keys, c, ast, kw, g)
    dcols = {it.col for it in agg_items if it.distinct}
    dcols |= {it.col for it, _ in ast.order_by
              if it.kind == "agg" and it.distinct}
    if dcols:
        g["distinct"] = {
            c: _distinct_per_group(src, keys, c, ast, kw, g)
            for c in dcols
        }
    return _groups_to_result(ast, keys, g, src=src, kw=kw)


_TOPK_VALUE_TYPES = ("int32", "float32", "float", "date")
_TOPK_DISTINCT_TYPES = ("int32", "int64", "float32", "float", "date", "str",
                        "bytes")


def _device_topk_plan(ast: _Ast, keys: List[str], src, kw):
    """(values, distinct, order) for groupby_topk when the card can
    reduce, order and cut this GROUP BY itself, else None (the general
    executor runs it). It does when the statement has a LIMIT or counts
    DISTINCT values, has no HAVING, reads one table (no corpus), selects
    only keys and COUNT(*), COUNT(DISTINCT col) or numeric
    COUNT/SUM/MIN/MAX/AVG, and orders by keys and counts alone."""
    from .corpus_api import CsvCorpus

    aggs = [it for it in ast.items if it.kind == "agg"]
    if (isinstance(src, CsvCorpus) or ast.having is not None
            or (ast.limit is None and not any(it.distinct for it in aggs))):
        return None
    values, distinct = [], []

    def _need(it) -> bool:
        if it.fn == "group_concat" or not (it.col is None
                                            or isinstance(it.col, str)):
            return False
        if it.distinct:
            if it.fn != "count" or _sql_col_type(
                    src, it.col, kw) not in _TOPK_DISTINCT_TYPES:
                return False
            if it.col not in distinct:
                distinct.append(it.col)
        elif it.col is not None:
            if _sql_col_type(src, it.col, kw) not in _TOPK_VALUE_TYPES:
                return False
            if it.col not in values:
                values.append(it.col)
        return True

    if not all(_need(it) for it in aggs):
        return None
    named = {it.name(): it for it in ast.items}
    order = []
    for it, desc in ast.order_by:
        # a name resolves to the output column first, as the host sort
        # does; a bare column must be one
        it = named.get(it.name(), it if it.kind == "agg" else None)
        if it is None:
            return None
        if it.kind == "col" and it.col in keys:
            order.append((("key", keys.index(it.col)), bool(desc)))
        elif it.kind == "agg" and it.fn == "count" and _need(it):
            what = ("count" if it.col is None
                    else ("distinct" if it.distinct else "count", it.col))
            order.append((what, bool(desc)))
        else:
            return None
    return values, distinct, order


def _pykey(x):
    """Normalize a group-key cell to a plain Python scalar so key
    tuples built from different array dtypes (int32 column vs int64
    group keys, np.str_ vs str) compare equal in host dicts."""
    return x.item() if isinstance(x, np.generic) else x


def _sql_col_type(src, col, kw) -> Optional[str]:
    """Resolved type of a source column: the session schema's entry,
    else the same sample inference the executors use (src is already a
    resolved tape here — resolving again is cheap). None when the
    column doesn't exist (the executor raises its canonical error)."""
    from .frame import parse_spec

    sch = kw["schema"] or {}
    sp = sch.get(col)
    if sp is not None:
        return parse_spec(sp).type
    from .corpus_api import CsvCorpus

    if isinstance(src, CsvCorpus):
        from .query import _lock_corpus_spec

        try:
            return parse_spec(
                _lock_corpus_spec(src, col, None, kw["sample"])).type
        except (KeyError, ValueError):
            return None
    from .frame import _resolve_tape
    from .query import infer_col

    tape, names = _resolve_tape(src, kw["dialect"], kw["backend"],
                                kw["engine"], False, kw["device"])
    if col not in names:
        return None
    return infer_col(tape, names, names.index(col), kw["sample"]).type


def _text_str(v) -> str:
    return (bytes(v).decode("utf-8", "surrogateescape")
            if isinstance(v, (bytes, np.bytes_)) else str(v))


def _text_aggs_per_group(src, keys, col, ast, kw, g) -> Dict:
    """MIN/MAX/COUNT over a TEXT column, per group, aligned with `g`'s
    group rows. Same trick as _distinct_per_group: a device pair
    group-by over (group keys + col) yields one row per distinct
    (group, value) pair WITH per-pair row counts — the text values ride
    the composite key (group keys may be text), so min/max reduce over
    each group's distinct values and COUNT sums the pair counts, all in
    O(#distinct pairs) host work. Groups absent from the pair table
    (all values NULL) aggregate to None / count 0."""
    from .query import groupby_typed

    if col in keys:
        # MIN/MAX/COUNT of a group KEY: the group rows already carry
        # the value (one per group) and the row count
        gkeys0 = (g["keys"] if isinstance(g["keys"], list)
                  else [g["keys"]])
        vals0 = np.array(
            [_text_str(v)
             for v in np.asarray(gkeys0[keys.index(col)])], object)
        return {"count": np.asarray(g["count"]).astype(np.int64),
                "min": vals0, "max": vals0.copy(),
                "sum": np.array([None] * len(vals0), object)}
    sch = kw["schema"] or {}
    pk = list(keys) + [col]
    pg = groupby_typed(
        src, pk, [pk[0]], key_spec=[sch.get(k) for k in pk],
        value_spec=["float"], where=ast.where, schema=kw["schema"],
        engine=kw["engine"], backend=kw["backend"],
        dialect=kw["dialect"], sample=kw["sample"],
        device=kw["device"],
    )
    pkeys = pg["keys"] if isinstance(pg["keys"], list) else [pg["keys"]]
    nk = len(keys)
    pcols = [np.asarray(a) for a in pkeys[:nk]]
    vals = np.asarray(pkeys[nk])
    cnts = np.asarray(pg["count"])
    per: Dict[tuple, list] = {}  # group -> [count, min, max]
    for i in range(int(cnts.shape[0])):
        t = tuple(_pykey(a[i]) for a in pcols)
        v = _text_str(vals[i])
        e = per.get(t)
        if e is None:
            per[t] = [int(cnts[i]), v, v]
        else:
            e[0] += int(cnts[i])
            if v < e[1]:
                e[1] = v
            if v > e[2]:
                e[2] = v
    gkeys = g["keys"] if isinstance(g["keys"], list) else [g["keys"]]
    gcols = [np.asarray(a) for a in gkeys]
    n = int(np.asarray(g["count"]).shape[0])
    rows = [per.get(tuple(_pykey(a[i]) for a in gcols)) for i in
            range(n)]
    return {
        "count": np.array([r[0] if r else 0 for r in rows], np.int64),
        "min": np.array([r[1] if r else None for r in rows], object),
        "max": np.array([r[2] if r else None for r in rows], object),
        "sum": np.array([None] * n, object),
    }


def _distinct_per_group(src, keys, col, ast, kw, g) -> np.ndarray:
    """COUNT(DISTINCT col) per group, aligned with `g`'s group rows.

    A SECOND device group-by over the composite (group keys + col) key
    yields one row per distinct (group, value) pair — rows whose `col`
    fails its typed parse drop out of the composite key, which is
    exactly SQL's rule that NULLs don't count — and a tiny host pass
    tallies pairs per group (O(#distinct pairs), never O(rows)).
    Groups absent from the pair table (all values NULL) count 0."""
    from .query import groupby_typed

    sch = kw["schema"] or {}
    pk = list(keys) + [col]
    pg = groupby_typed(
        src, pk, [pk[0]], key_spec=[sch.get(k) for k in pk],
        value_spec=["float"], where=ast.where, schema=kw["schema"],
        engine=kw["engine"], backend=kw["backend"],
        dialect=kw["dialect"], sample=kw["sample"],
        device=kw["device"],
    )
    pkeys = pg["keys"] if isinstance(pg["keys"], list) else [pg["keys"]]
    nk = len(keys)
    pcols = [np.asarray(a) for a in pkeys[:nk]]
    counts: Dict[tuple, int] = {}
    for i in range(int(np.asarray(pg["count"]).shape[0])):
        t = tuple(_pykey(a[i]) for a in pcols)
        counts[t] = counts.get(t, 0) + 1
    gkeys = g["keys"] if isinstance(g["keys"], list) else [g["keys"]]
    gcols = [np.asarray(a) for a in gkeys]
    return np.array(
        [counts.get(tuple(_pykey(a[i]) for a in gcols), 0)
         for i in range(int(np.asarray(g["count"]).shape[0]))],
        np.int64,
    )


def _groups_to_result(ast: _Ast, keys: List[str], g: Dict,
                      src=None, kw=None) -> SqlResult:
    """Shared assembly: a group-by dict ({"keys","count","aggs"}) +
    the SELECT items -> SqlResult with ORDER BY/LIMIT applied. Item
    col names must already match `keys` / the aggs keys."""
    agg_items = [it for it in ast.items if it.kind == "agg"]
    key_arrays = g["keys"] if isinstance(g["keys"], list) else [g["keys"]]
    n = int(np.asarray(g["count"]).shape[0])

    names: List[str] = []
    columns: Dict[str, np.ndarray] = {}
    types: Dict[str, str] = {}

    def _add(name, arr, t):
        if name in columns:
            raise SqlError(f"duplicate output column {name!r} (use AS)")
        names.append(name)
        columns[name] = np.asarray(arr)
        types[name] = t

    items = (ast.items if agg_items or not ast.distinct
             else [_Item("col", col=k) for k in keys])
    for it in items:
        if it.kind == "col":
            arr = key_arrays[keys.index(it.col)]
            _add(it.name(), arr,
                 "str" if np.asarray(arr).dtype == object else "int64")
        elif it.fn == "count" and it.col is None:
            _add(it.name(), np.asarray(g["count"]), "int64")
        elif it.distinct:
            _add(it.name(), g["distinct"][it.col], "int64")
        elif it.fn == "group_concat":
            if src is None:
                raise SqlError(
                    "GROUP_CONCAT is supported on base-table GROUP "
                    "BY only (not joins/corpus merges) — materialize "
                    "first")
            _add(it.name(),
                 _group_concat_column(src, keys, it, ast, kw, g),
                 "str")
        else:
            key = it.col if isinstance(it.col, str) else str(it.col)
            arr, t = _agg_array(g["aggs"], key, it.fn)
            _add(it.name(), arr, t)
    if ast.order_by:
        order = []
        for it, desc in ast.order_by:
            nm = it.name()
            if nm not in columns and it.kind == "agg":
                # ORDER BY an aggregate not in the SELECT list
                if it.distinct:
                    arr = g["distinct"][it.col]
                else:
                    arr, _t = (np.asarray(g["count"]), "int64") \
                        if (it.fn == "count" and it.col is None) \
                        else _agg_array(
                            g["aggs"],
                            it.col if isinstance(it.col, str)
                            else str(it.col),
                            it.fn)
                columns[nm] = np.asarray(arr)
            elif nm not in columns:
                raise SqlError(
                    f"ORDER BY column {nm!r} is not in the result"
                )
            order.append((nm, desc))
        perm = _order_group_rows(columns, order, n)
        for nm in list(columns):
            columns[nm] = columns[nm][perm]
    if ast.limit is not None or ast.offset:
        lo = ast.offset
        hi = n if ast.limit is None else lo + ast.limit
        for nm in list(columns):
            columns[nm] = columns[nm][lo:hi]
        n = max(0, min(n, hi) - lo)
    columns = {nm: columns[nm] for nm in names}
    return SqlResult(names, columns, types, n)


def _having_cols(expr):
    from .query import _where_leaves

    if expr is None:
        return
    for target, _, _ in _where_leaves(expr):
        if "." in target:
            yield target.rsplit(".", 1)[0]


def _resolve_having(expr, resolve):
    """Rewrite having-leaf targets ('col.fn' / qualified 'a.col.fn')
    onto joined-frame column names."""
    if expr is None:
        return None
    if isinstance(expr, tuple) and len(expr) == 3 \
            and isinstance(expr[1], str):
        target, op, lit = expr
        if target == "count":
            return expr
        col, fn = target.rsplit(".", 1)
        return (f"{resolve(col)}.{fn}", op, lit)
    if isinstance(expr, tuple) and len(expr) == 2 \
            and expr[0] in ("and", "or"):
        return (expr[0], [_resolve_having(e, resolve) for e in expr[1]])
    if isinstance(expr, tuple) and len(expr) == 2 and expr[0] == "not":
        return ("not", _resolve_having(expr[1], resolve))
    raise SqlError(f"bad having expression: {expr!r}")


def _frame_codes(fr, keys: List[str]):
    """Factorize frame key column(s) to one int64 code per row (first
    key major — group order comes out lexicographic) + combined key
    validity + a decode back to per-key value arrays."""
    n = len(fr)
    kok = np.ones(n, bool)
    codes = np.zeros(n, np.int64)
    uniqs = []
    space = 1
    for kn in keys:
        vals = np.asarray(fr._columns[kn])
        okm = fr._ok[kn]
        if okm is not None:
            kok = kok & np.asarray(okm, bool)
        uniq, inv = np.unique(vals, return_inverse=True)
        uniqs.append(uniq)
        space *= max(len(uniq), 1)
        if space >= 2**62:
            raise SqlError(
                "composite GROUP BY key space too large to combine"
            )
        codes = codes * max(len(uniq), 1) + inv.astype(np.int64)

    def decode(uk):
        uk = np.asarray(uk, np.int64)
        arrs = []
        rem = uk.copy()
        for uniq in reversed(uniqs):
            m = max(len(uniq), 1)
            arrs.append(uniq[rem % m] if len(uniq)
                        else np.zeros(0, object))
            rem = rem // m
        arrs.reverse()
        return arrs if len(arrs) > 1 else arrs[0]

    return codes, kok, decode


def _frame_scalar_aggs(ast: _Ast, fr, resolve) -> SqlResult:
    """Aggregates with no GROUP BY over a joined frame: one result
    row, host reduce with exact integer sums."""
    if ast.order_by:
        raise SqlError("ORDER BY is meaningless for a one-row aggregate")
    names, columns, types = [], {}, {}
    for it in ast.items:
        if it.kind != "agg":
            raise SqlError(
                f"column {it.col!r} must appear in GROUP BY or inside "
                "an aggregate"
            )
        if it.fn == "count" and it.col is None:
            val, t = len(fr), "int64"
        else:
            from .query import VExpr

            if isinstance(it.col, VExpr):
                # aggregate of an arithmetic expression over the
                # joined frame (host twin of the device path)
                colvals, okm, col = _expr_column(fr, it.col, resolve)
                colvals = np.asarray(colvals)
            else:
                c = resolve(it.col)
                col = fr.schema[c]
                okm = fr._ok[c]
                colvals = np.asarray(fr._columns[c])
            ok = (np.ones(len(fr), bool) if okm is None
                  else np.asarray(okm, bool))
            if it.fn == "group_concat":
                # whole-input GROUP_CONCAT: non-NULL values in record
                # order (any column type; numerics stringify)
                txt = [v if isinstance(v, str)
                       else v.decode("utf-8", "surrogateescape")
                       if isinstance(v, (bytes, np.bytes_)) else str(v)
                       for v in colvals[ok]]
                val = getattr(it, "sep", ",").join(txt) if txt else None
                t = "str"
            elif col.type in ("str", "bytes") and it.fn != "count":
                raise SqlError(
                    f"{it.fn}({it.col}) needs a numeric column; "
                    f"{it.col!r} is text"
                )
            elif it.fn == "count":
                if it.distinct:
                    val = len({_pykey(v) for v in colvals[ok]})
                else:
                    val = int(ok.sum())
                t = "int64"
            else:
                sel = colvals[ok]
                if sel.dtype.kind == "M":
                    # datetime64 -> epoch ints, matching the non-join
                    # aggregate paths (dates reduce as epoch values)
                    sel = sel.astype(np.int64)
                isf = col.type in ("float", "float32")
                if sel.size == 0:
                    val = np.nan if it.fn == "mean" else None
                    t = "float" if isf or it.fn == "mean" else "int64"
                elif it.fn == "mean":
                    val, t = float(np.asarray(sel, np.float64).mean()),                         "float"
                elif isf:
                    val = float({"sum": np.sum, "min": np.min,
                                 "max": np.max}[it.fn](sel))
                    t = "float"
                else:
                    ints = [int(v) for v in sel.tolist()]
                    val = {"sum": sum, "min": min, "max": max}[it.fn](ints)
                    t = "int64"
        nm = it.name()
        if nm in columns:
            raise SqlError(f"duplicate output column {nm!r} (use AS)")
        names.append(nm)
        columns[nm] = np.asarray([val], object)
        types[nm] = t
    return _slice_one_row(names, columns, types, ast)


def _run_join_groupby(ast: _Ast, fr, resolve) -> SqlResult:
    """GROUP BY / DISTINCT over a joined frame: host grouping with the
    same exact reduce the corpus paths use (query._group_multi)."""
    from .query import _filter_groups, _group_multi, _having_mask

    def _res_item(it: _Item) -> _Item:
        if it.kind == "star":
            raise SqlError("SELECT * cannot combine with GROUP BY")
        if it.kind in ("fold", "window"):
            raise SqlError(
                "text-function/window items cannot combine with "
                "GROUP BY (select them without GROUP BY)"
            )
        if not isinstance(it.col, (str, type(None))):
            raise SqlError(
                "aggregates over arithmetic expressions are not "
                "supported with GROUP BY over a JOIN yet — join "
                "first, or aggregate per side"
            )
        return _Item(it.kind,
                     col=(resolve(it.col) if it.col is not None
                          else None),
                     fn=it.fn, alias=it.alias, distinct=it.distinct)

    def _res_order(it: _Item) -> _Item:
        if it.kind == "col":
            try:
                return _Item("col", col=resolve(it.col), alias=it.alias)
            except SqlError:
                # not a frame column: an output alias (e.g. ORDER BY
                # tot) — the assembly resolves it against the result
                return it
        return _res_item(it)

    ast2 = _Ast()
    ast2.distinct = ast.distinct
    ast2.items = [_res_item(it) for it in ast.items]
    ast2.group_by = [resolve(k) for k in ast.group_by]
    ast2.having = _resolve_having(ast.having, resolve)
    ast2.order_by = [(_res_order(it), d) for it, d in ast.order_by]
    ast2.limit = ast.limit
    ast2.offset = ast.offset

    keys = ast2.group_by or [it.col for it in ast2.items
                             if it.kind == "col"]
    if not keys:
        raise SqlError("SELECT DISTINCT needs column names")
    agg_items = []
    for it in ast2.items:
        if it.kind == "col" and it.col not in keys:
            raise SqlError(
                f"column {it.col!r} must appear in GROUP BY or inside "
                "an aggregate"
            )
        if it.kind == "agg":
            agg_items.append(it)
    value_cols: List[str] = []
    for it in agg_items:
        if (it.col is not None and not it.distinct
                and it.col not in value_cols):
            value_cols.append(it.col)
    for col in _having_cols(ast2.having):
        if col not in value_cols:
            value_cols.append(col)
    for it, _ in ast2.order_by:
        if (it.kind == "agg" and it.col is not None
                and not it.distinct and it.col not in value_cols):
            value_cols.append(it.col)
    for it in agg_items:
        if it.fn == "group_concat":
            raise SqlError(
                "GROUP_CONCAT over a JOIN / derived frame is not "
                "supported — group on the base table, or materialize "
                "the join first (WITH ... )"
            )
        if (it.col is not None
                and fr.schema[it.col].type in ("str", "bytes")
                and it.fn != "count"):
            raise SqlError(
                f"{it.fn}({it.col}) needs a numeric column; "
                f"{it.col!r} is text"
            )

    kv, kok, decode = _frame_codes(fr, keys)
    values: Dict[str, tuple] = {}
    for c in value_cols:
        col = fr.schema[c]
        okm = fr._ok[c]
        ok = (np.ones(len(fr), bool) if okm is None
              else np.asarray(okm, bool))
        if col.type in ("str", "bytes"):
            # only COUNT over text (validated above): the values are
            # never reduced, only their validity is counted
            values[c] = (np.zeros(len(fr), np.int64), ok, False)
        else:
            vv = np.asarray(fr._columns[c])
            if vv.dtype.kind == "M":
                vv = vv.astype(np.int64)  # epoch ints, like non-join
            values[c] = (vv, ok, col.type in ("float", "float32"))
    if not values:
        # COUNT(*)/DISTINCT: ride a dummy value (aggregates unread)
        values[keys[0]] = (np.zeros(len(fr), np.int64),
                           np.zeros(len(fr), bool), False)
    g = _group_multi("host", kv, kok, decode, values)
    if ast2.having is not None:
        g = _filter_groups(g, _having_mask(g, ast2.having))
    dcols = {it.col for it in agg_items if it.distinct}
    dcols |= {it.col for it, _ in ast2.order_by
              if it.kind == "agg" and it.distinct}
    if dcols:
        g["distinct"] = {
            c: _frame_distinct_per_group(fr, keys, c, g)
            for c in dcols
        }
    return _groups_to_result(ast2, keys, g)


def _frame_distinct_per_group(fr, keys, col, g) -> np.ndarray:
    """COUNT(DISTINCT col) per group over a materialized (joined)
    frame — host twin of _distinct_per_group: tally unique
    (key..., value) tuples among rows where the keys AND the value
    all parsed ok, then align counts to `g`'s group rows."""
    n = len(fr)

    def _okm(c):
        m = fr._ok[c]
        return np.ones(n, bool) if m is None else np.asarray(m, bool)

    valid = _okm(col)
    for k in keys:
        valid &= _okm(k)
    kcols = [np.asarray(fr._columns[k]) for k in keys]
    vvals = np.asarray(fr._columns[col])
    seen = set()
    counts: Dict[tuple, int] = {}
    for i in np.flatnonzero(valid):
        kt = tuple(_pykey(a[i]) for a in kcols)
        pair = (kt, _pykey(vvals[i]))
        if pair not in seen:
            seen.add(pair)
            counts[kt] = counts.get(kt, 0) + 1
    gkeys = g["keys"] if isinstance(g["keys"], list) else [g["keys"]]
    gcols = [np.asarray(a) for a in gkeys]
    return np.array(
        [counts.get(tuple(_pykey(a[i]) for a in gcols), 0)
         for i in range(int(np.asarray(g["count"]).shape[0]))],
        np.int64,
    )


def _count_rows(src, where, kw) -> int:
    """COUNT(*) with no other aggregate: the record count (or the
    pushed-down selection size) — never materializes columns."""
    from .corpus_api import CsvCorpus
    from .frame import _resolve_tape
    from .query import _lock_where_schema, select_records

    if isinstance(src, CsvCorpus):
        if where is None:
            return int(src.num_records)
        names = src.header_names()
        wsch = _lock_where_schema(src, where, kw["schema"],
                                  kw["sample"])
        return sum(
            len(select_records(t, where, names=names, schema=wsch,
                               dialect=kw["dialect"],
                               sample=kw["sample"]))
            for t in src.device_tapes()
        )
    tape, names = _resolve_tape(src, kw["dialect"], kw["backend"],
                                kw["engine"], False, kw["device"])
    if where is None:
        return int(getattr(tape, "num_data_records",
                           int(tape.record_cnt) - 1))
    return len(select_records(tape, where, names=names,
                              schema=kw["schema"],
                              dialect=kw["dialect"],
                              sample=kw["sample"]))


def _slice_one_row(names, columns, types, ast) -> SqlResult:
    """LIMIT/OFFSET over the single scalar-aggregate result row."""
    lo = min(ast.offset, 1)
    hi = 1 if ast.limit is None else min(lo + ast.limit, 1)
    n = max(0, hi - lo)
    if n == 0:
        columns = {nm: columns[nm][:0] for nm in names}
    return SqlResult(names, columns, types, n)


def _scalar_text_minmax(src, col: str, fn: str, ast, kw):
    """Scalar MIN/MAX of a text column: distinct values via a device
    group-by keyed by the column, lexicographic reduce on host."""
    from .query import groupby_typed

    sch = kw["schema"] or {}
    dg = groupby_typed(
        src, col, [col], key_spec=sch.get(col), value_spec=["float"],
        where=ast.where, schema=kw["schema"], engine=kw["engine"],
        backend=kw["backend"], dialect=kw["dialect"],
        sample=kw["sample"], device=kw["device"],
    )
    ka = dg["keys"][0] if isinstance(dg["keys"], list) else dg["keys"]
    vals = [_text_str(v) for v in np.asarray(ka)]
    if not vals:
        return None
    return min(vals) if fn == "min" else max(vals)


def _run_scalar_aggs(ast: _Ast, src, kw):
    """Aggregates with no GROUP BY: one result row over the (filtered)
    table, via per-column device stats."""
    from .query import column_stats

    if ast.having is not None:
        raise SqlError("HAVING needs GROUP BY")
    if ast.order_by:
        raise SqlError("ORDER BY is meaningless for a one-row aggregate")
    for it in ast.items:
        if it.kind != "agg":
            raise SqlError(
                f"column {it.col!r} must appear in GROUP BY or inside "
                "an aggregate"
            )
    stats: Dict[str, object] = {}

    def _stats(col):
        if col not in stats:
            from .query import VExpr

            sch = kw["schema"] or {}
            spec = (
                ({r: sch[r] for r in col.columns() if r in sch} or None)
                if isinstance(col, VExpr) else sch.get(col)
            )
            stats[col] = column_stats(
                src, col, spec, where=ast.where,
                schema=kw["schema"], engine=kw["engine"],
                backend=kw["backend"], dialect=kw["dialect"],
                sample=kw["sample"], device=kw["device"],
            )
        return stats[col]

    names, columns, types = [], {}, {}
    for it in ast.items:
        if it.distinct:
            # COUNT(DISTINCT col): group by the column itself (probe
            # values, unread) — the number of GROUPS is the distinct
            # count, and rows whose col fails its typed parse never
            # form a group (SQL: NULLs don't count)
            from .query import groupby_typed

            sch = kw["schema"] or {}
            dg = groupby_typed(
                src, it.col, [it.col], key_spec=sch.get(it.col),
                value_spec=["float"], where=ast.where,
                schema=kw["schema"], engine=kw["engine"],
                backend=kw["backend"], dialect=kw["dialect"],
                sample=kw["sample"], device=kw["device"],
            )
            val, t = int(np.asarray(dg["count"]).shape[0]), "int64"
        elif it.fn == "count" and it.col is None:
            probe = next((o.col for o in ast.items
                          if o.col is not None), None)
            if probe is not None:
                # COUNT(*) = Stats.count (rows after where) — shares
                # the device stats another item already needs
                val, t = _stats(probe).count, "int64"
            else:
                val, t = _count_rows(src, ast.where, kw), "int64"
        elif it.fn == "group_concat":
            # whole-table GROUP_CONCAT: non-NULL values in record
            # order (host text assembly, like the CSV writer)
            from .frame import read_typed

            gfr = read_typed(
                src, kw["schema"], columns=[it.col], where=ast.where,
                engine=kw["engine"], backend=kw["backend"],
                dialect=kw["dialect"], sample=kw["sample"],
                device=kw["device"],
            )
            gok = gfr._ok.get(it.col)
            gvals = np.asarray(gfr._columns[it.col])
            txt = [v if isinstance(v, str)
                   else v.decode("utf-8", "surrogateescape")
                   if isinstance(v, (bytes, np.bytes_)) else str(v)
                   for i, v in enumerate(gvals)
                   if gok is None or gok[i]]
            val = getattr(it, "sep", ",").join(txt) if txt else None
            t = "str"
        else:
            st = _stats(it.col)
            if it.fn == "count":
                val, t = st.ok_count, "int64"
            elif it.fn == "mean":
                val, t = st.mean, "float"
                if val is None and st.ok_count:
                    raise SqlError(
                        f"AVG() over text column {it.col!r} — text "
                        "aggregates are MIN/MAX/COUNT"
                    )
            else:
                val = getattr(st, it.fn)
                t = "float" if isinstance(val, float) else "int64"
                if val is None and st.ok_count \
                        and isinstance(it.col, str):
                    # numeric aggregate unavailable: a TEXT column.
                    # MIN/MAX reduce lexicographically over the
                    # column's distinct values (device group-by keyed
                    # by the column, O(#distinct) host reduce)
                    if it.fn not in ("min", "max"):
                        raise SqlError(
                            f"{it.fn.upper()}() over text column "
                            f"{it.col!r} — text aggregates are "
                            "MIN/MAX/COUNT"
                        )
                    val = _scalar_text_minmax(src, it.col, it.fn,
                                              ast, kw)
                    t = "str"
        nm = it.name()
        if nm in columns:
            raise SqlError(f"duplicate output column {nm!r} (use AS)")
        names.append(nm)
        columns[nm] = np.asarray([val], object)
        types[nm] = t
    return _slice_one_row(names, columns, types, ast)


# ---------------------------------------------------------------- joins


def _try_join_groupby_pushdown(ast, lt, ln, rt, rn, on_l, on_r,
                               l_alias, r_alias, kw):
    """GROUP BY over a join, pushed down: when the group keys are
    exactly the join keys, an inner/left/right join's aggregates
    decompose into PER-SIDE device group-bys (query.groupby_typed runs
    where each table's values live) combined by tiny host arithmetic
    over groups — the joined frame is never materialized:

      group g pairs every left row with every right row of that key, so
      COUNT(*) = nl*nr, SUM(l.c) = suml(c)*nr, COUNT(l.c) = cntl(c)*nr,
      MIN/MAX(l.c) unchanged, AVG(l.c) = suml/cntl (the nr cancels);
      LEFT JOIN keeps nl-row groups with no right match (multiplier 1).

    Returns a SqlResult, or None when the statement is not eligible
    (keys don't align with the ON pairs, a WHERE conjunct straddles the
    join or sits on the nullable side of an outer join, FULL OUTER, or
    the two sides type their keys differently) — the caller then falls
    back to the host group over the joined frame."""
    from .query import (
        _filter_groups,
        _having_mask,
        _where_leaves,
        groupby_typed,
        infer_col,
    )

    if any(it.kind == "agg" and it.distinct for it in ast.items) or \
            any(it.kind == "agg" and it.distinct
                for it, _ in ast.order_by):
        # COUNT(DISTINCT) over a join: the host group over the joined
        # frame handles it (per-side multiplicity arithmetic doesn't
        # carry distinct counts through an inner/left multiplier of 0)
        return None

    how = ast.join_how
    if how not in ("inner", "left", "right"):
        return None

    def _side_of(ref: str):
        side, col = _split_qualified(ref, l_alias, r_alias)
        if side is None:
            if col in ln:
                side = "l"  # bare name in both sides = left (frame rule)
            elif col in rn:
                side = "r"
            else:
                return None, col
        elif col not in (ln if side == "l" else rn):
            return None, col
        return side, col

    def _frame_name(side: str, col: str) -> str:
        # mirror join_typed's column naming so output names (and the
        # resolver the host path would use) are identical
        return col + "_right" if (side == "r" and col in ln) else col

    # --- group keys must cover the ON pairs exactly once each ---
    pairs = list(zip(on_l, on_r))
    if len(ast.group_by) != len(pairs):
        return None
    key_sides = []  # (side, col, pair_idx) in ast.group_by order
    taken = set()
    for ref in ast.group_by:
        side, col = _side_of(ref)
        if side is None:
            return None
        want = on_l if side == "l" else on_r
        hit = next((i for i, c in enumerate(want)
                    if c == col and i not in taken), None)
        if hit is None:
            return None
        taken.add(hit)
        key_sides.append((side, col, hit))

    # --- both sides must type each key pair identically (else the
    #     decoded group keys would not compare across sides) ---
    sch_l = kw["schema"] or {}
    sch_r = kw["right_schema"] or {}

    def _key_col(side, col):
        sch, tape, names = ((sch_l, lt, ln) if side == "l"
                            else (sch_r, rt, rn))
        from .frame import parse_spec

        if sch.get(col) is not None:
            return parse_spec(sch.get(col))
        try:
            f = next(i for i, n in enumerate(names) if n == col)
        except StopIteration:
            return None
        return infer_col(tape, names, f, kw["sample"])

    def _col_sig(c):
        return (c.type, getattr(c, "unit", None), getattr(c, "scale", None))

    for i, (kl, kr) in enumerate(pairs):
        cl, cr = _key_col("l", kl), _key_col("r", kr)
        if cl is None or cr is None or _col_sig(cl) != _col_sig(cr):
            return None

    # --- split WHERE into per-side conjuncts (bail if any straddles
    #     the join or sits on the nullable side of a LEFT/RIGHT join:
    #     post-join NULL semantics differ from a pre-join filter) ---
    def _conjuncts(where):
        if where is None:
            return []
        if isinstance(where, list):
            return list(where)
        if isinstance(where, tuple) and len(where) == 2 \
                and where[0] == "and":
            return list(where[1])
        return [where]

    def _rewrite(expr):
        if isinstance(expr, tuple) and len(expr) == 3 \
                and isinstance(expr[1], str):
            return (_side_of(expr[0])[1], expr[1], expr[2])
        if isinstance(expr, tuple) and len(expr) == 2 \
                and expr[0] in ("and", "or"):
            return (expr[0], [_rewrite(e) for e in expr[1]])
        if isinstance(expr, tuple) and len(expr) == 2 \
                and expr[0] == "not":
            return ("not", _rewrite(expr[1]))
        if isinstance(expr, list):
            return [_rewrite(e) for e in expr]
        return expr

    where_side: Dict[str, list] = {"l": [], "r": []}
    for cj in _conjuncts(ast.where):
        sides = set()
        for ref, _op, _v in _where_leaves(cj):
            if not isinstance(ref, str):
                return None  # arithmetic leaf: host path handles it
            s, _c = _side_of(ref)
            if s is None:
                return None
            sides.add(s)
        if len(sides) != 1:
            return None
        s = sides.pop()
        if (how == "left" and s == "r") or (how == "right" and s == "l"):
            return None  # pre-filtering the nullable side is not
            # equivalent to the post-join NULL semantics
        where_side[s].append(_rewrite(cj))

    # --- aggregate/HAVING/ORDER BY value columns, per side ---
    agg_refs = [it.col for it in ast.items
                if it.kind == "agg" and it.col is not None]
    agg_refs += list(_having_cols(ast.having))
    agg_refs += [it.col for it, _ in ast.order_by
                 if it.kind == "agg" and it.col is not None]
    side_vals: Dict[str, List[str]] = {"l": [], "r": []}
    for ref in agg_refs:
        if not isinstance(ref, str):
            return None  # expression aggregate: host path reports it
        side, col = _side_of(ref)
        if side is None:
            return None
        if col not in side_vals[side]:
            side_vals[side].append(col)
    # non-count aggregates over text columns: let the host path raise
    # its uniform error (bail keeps the two paths' diagnostics one)
    for it in ast.items:
        if it.kind == "agg" and it.col is not None and it.fn != "count":
            side, col = _side_of(it.col)
            c = _key_col(side, col)
            if c is not None and c.type in ("str", "bytes"):
                return None

    # --- per-side device group-bys ---
    def _side_group(side):
        tape, names, sch = ((lt, ln, sch_l) if side == "l"
                            else (rt, rn, sch_r))
        keys = [pairs[i][0 if side == "l" else 1]
                for i in range(len(pairs))]
        key_spec = [sch.get(k) for k in keys]
        vals = list(side_vals[side])
        if vals:
            val_spec = [sch.get(v) for v in vals]
        else:
            # COUNT(*)-style probe: value aggregates unread, group keys
            # and per-group row counts are value-independent
            vals, val_spec = [keys[0]], ["float"]
        where = (where_side[side] or None)
        return groupby_typed(
            tape, keys if len(keys) > 1 else keys[0], vals,
            key_spec=(key_spec if len(keys) > 1 else key_spec[0]),
            value_spec=val_spec, where=where,
            schema=(sch or None),
            engine=kw["engine"], backend=kw["backend"],
            dialect=kw["dialect"], sample=kw["sample"],
            device=kw["device"],
        )

    lg, rg = _side_group("l"), _side_group("r")

    def _tuples(g):
        ka = g["keys"] if isinstance(g["keys"], list) else [g["keys"]]
        cols = [np.asarray(a).tolist() for a in ka]
        return list(zip(*cols)) if cols and len(cols[0]) else []

    lmap = {t: i for i, t in enumerate(_tuples(lg))}
    rmap = {t: i for i, t in enumerate(_tuples(rg))}
    # a group key taken from the OTHER side is absent (invalid) on the
    # unmatched rows a LEFT/RIGHT join keeps — the host grouping drops
    # those rows, so the effective semantics collapse to inner
    key_side_set = {s for s, _c, _i in key_sides}
    eff = how
    if (how == "left" and "r" in key_side_set) or \
            (how == "right" and "l" in key_side_set):
        eff = "inner"
    if eff == "inner":
        out_keys = sorted(set(lmap) & set(rmap))
    elif eff == "left":
        out_keys = sorted(lmap)
    else:
        out_keys = sorted(rmap)

    lcnt = np.asarray(lg["count"])
    rcnt = np.asarray(rg["count"])
    counts, rows_l, rows_r = [], [], []
    for t in out_keys:
        il, ir = lmap.get(t), rmap.get(t)
        nl = int(lcnt[il]) if il is not None else 0
        nr = int(rcnt[ir]) if ir is not None else 0
        rows_l.append((il, nl, nr))
        rows_r.append((ir, nl, nr))
        if nl and nr:
            counts.append(nl * nr)
        else:
            counts.append(nl if eff == "left" else nr)

    aggs: Dict[str, Dict[str, np.ndarray]] = {}

    def _combine(side, col, g, rows):
        a = g["aggs"][col]
        is_f = np.asarray(a["sum"]).dtype.kind == "f"
        sums, mins, maxs, cnts = [], [], [], []
        for idx, nl, nr in rows:
            # each row of this side appears once per matching row of
            # the OTHER side; a LEFT(/RIGHT) join keeps unmatched
            # left(/right) rows exactly once
            other = nr if side == "l" else nl
            kept_alone = (eff == "left" and side == "l") or \
                (eff == "right" and side == "r")
            m = other if other else (1 if kept_alone else 0)
            c = int(a["count"][idx]) * m if idx is not None else 0
            if idx is not None and c:
                # plain Python scalars, matching the host reduce's
                # object arrays (exact int sums at any magnitude)
                if is_f:
                    sums.append(float(a["sum"][idx]) * m)
                    mins.append(float(a["min"][idx]))
                    maxs.append(float(a["max"][idx]))
                else:
                    sums.append(int(a["sum"][idx]) * m)
                    mins.append(int(a["min"][idx]))
                    maxs.append(int(a["max"][idx]))
            else:
                sums.append(0.0 if is_f else 0)
                mins.append(np.inf)
                maxs.append(-np.inf)
            cnts.append(c)
        dt = np.float64 if is_f else object
        return {
            "sum": np.array(sums, dt), "min": np.array(mins, dt),
            "max": np.array(maxs, dt),
            "count": np.array(cnts, np.int64),
        }

    for col in side_vals["l"]:
        aggs[_frame_name("l", col)] = _combine("l", col, lg, rows_l)
    for col in side_vals["r"]:
        aggs[_frame_name("r", col)] = _combine("r", col, rg, rows_r)

    # decoded key columns, back in ast.group_by order
    key_arrays = []
    src_maps = {"l": (lg, lmap), "r": (rg, rmap)}
    for pos, (side, col, pi) in enumerate(key_sides):
        g, _m = src_maps[side]
        ka = g["keys"] if isinstance(g["keys"], list) else [g["keys"]]
        key_arrays.append(np.array([t[pi] for t in out_keys],
                                   np.asarray(ka[pi]).dtype))

    gdict = {"keys": key_arrays if len(key_arrays) > 1 else key_arrays[0],
             "count": np.array(counts, np.int64), "aggs": aggs}

    def _resolve_ref(ref: str) -> str:
        side, col = _side_of(ref)
        if side is None:
            raise SqlError(f"no column {ref!r} in the joined result")
        return _frame_name(side, col)

    keys2 = [_frame_name(s, c) for s, c, _ in key_sides]
    ast2 = _Ast()
    ast2.distinct = ast.distinct
    try:
        ast2.items = [
            _Item(it.kind,
                  col=(_resolve_ref(it.col)
                       if isinstance(it.col, str) else it.col),
                  fn=it.fn, alias=it.alias)
            if it.kind != "star" else it
            for it in ast.items
        ]
    except SqlError:
        return None  # unknown column: the host path raises uniformly
    for it in ast2.items:
        if it.kind == "star" or (it.kind == "col"
                                 and it.col not in keys2):
            # SELECT * with GROUP BY / bare column outside the keys:
            # fall back so the host path raises its canonical error
            return None
    ast2.group_by = keys2
    ast2.having = _resolve_having(ast.having, _resolve_ref)
    ord2 = []
    for it, d in ast.order_by:
        if it.kind == "col":
            try:
                it = _Item("col", col=_resolve_ref(it.col),
                           alias=it.alias)
            except SqlError:
                pass  # output alias: resolved against the result
        else:
            it = _Item(it.kind, col=(_resolve_ref(it.col)
                                     if isinstance(it.col, str)
                                     else it.col),
                       fn=it.fn, alias=it.alias)
        ord2.append((it, d))
    ast2.order_by = ord2
    ast2.limit = ast.limit
    ast2.offset = ast.offset

    g = gdict
    if ast2.having is not None:
        g = _filter_groups(g, _having_mask(g, ast2.having))
    return _groups_to_result(ast2, keys2, g)


def _split_qualified(ref: str, l_alias: str, r_alias: str):
    """'a.col' -> (side, col); bare 'col' -> (None, col)."""
    if "." in ref:
        alias, col = ref.split(".", 1)
        if alias == l_alias:
            return "l", col
        if alias == r_alias:
            return "r", col
        raise SqlError(
            f"unknown table alias {alias!r} (have {l_alias!r}, "
            f"{r_alias!r})"
        )
    return None, ref


def _frame_join_source(sub, resolve_table, kw):
    """Materialize a derived table / CTE for use as a JOIN side:
    (csv bytes, {name: Col}) via the round-trip writer. Integer
    columns must fit int32 to survive the re-parse (exact aggregate
    sums can exceed it) — raise clearly instead of silently NULLing."""
    fr = _as_frame(_dispatch(sub, resolve_table, kw))
    for nm in fr.names:
        if fr.schema[nm].type != "int32":
            continue
        col = fr._columns[nm]
        okm = fr._ok[nm]
        try:
            a = np.asarray(col, dtype=np.int64)
        except (OverflowError, TypeError, ValueError):
            a = None
        if a is None or (
                (np.abs(a[np.asarray(okm, bool)] if okm is not None
                        else a) >= 2**31).any()):
            raise SqlError(
                f"derived-table join side: column {nm!r} holds "
                "integers outside int32 — they cannot round-trip "
                "through the join's typed re-parse (CAST or aggregate "
                "after the join instead)"
            )
    return fr.to_csv(), {nm: fr.schema[nm] for nm in fr.names}


@GLOBAL.span("sql.join")
def _run_join(ast: _Ast, left_src, right_src, kw):
    from .join import join_typed

    l_alias = ast.table_alias or (
        ast.table[1] if ast.table[0] == "name" else "l")
    r_alias = ast.join_alias or (
        ast.join_table[1] if ast.join_table[0] == "name" else "r")
    if l_alias == r_alias:
        if ast.table_alias or ast.join_alias:
            # an explicit alias colliding with the other side's name
            # would silently rebind the user's qualified refs
            raise SqlError(f"duplicate table alias {l_alias!r}")
        l_alias, r_alias = "l", "r"
    on_l, on_r = [], []
    for a, b in ast.join_on:
        sa, ca = _split_qualified(a, l_alias, r_alias)
        sb, cb = _split_qualified(b, l_alias, r_alias)
        if sa is None and sb is None:
            # both bare: positional — left side of '=' is the left
            # table's column
            sa, sb = "l", "r"
        elif sa is None:
            sa = "l" if sb == "r" else "r"
        elif sb is None:
            sb = "l" if sa == "r" else "r"
        if sa == sb:
            raise SqlError(
                "each ON condition must compare the two tables, e.g. "
                f"{l_alias}.key = {r_alias}.key"
            )
        (on_l, on_r)[sa == "r"].append(ca)
        (on_l, on_r)[sb == "r"].append(cb)
    # resolve both sources ONCE (each resolve on a path/bytes source is
    # a full structural-index build) and hand the tapes to join_typed —
    # the name list for ref resolution comes from the same resolve
    from .frame import _resolve_tape

    lt, ln = _resolve_tape(left_src, kw["dialect"], kw["backend"],
                           kw["engine"], False, kw["device"])
    rt, _rn = _resolve_tape(right_src, kw["dialect"], kw["backend"],
                            kw["engine"], False, kw["device"])
    if ast.group_by and ast.join_how != "cross":
        res = _try_join_groupby_pushdown(
            ast, lt, ln, rt, _rn, on_l, on_r, l_alias, r_alias, kw
        )
        if res is not None:
            return res
    fr = join_typed(
        lt, rt,
        (None if ast.join_how == "cross"
         else on_l if len(on_l) > 1 else on_l[0]),
        right_on=(None if ast.join_how == "cross"
                  else on_r if len(on_r) > 1 else on_r[0]),
        how=ast.join_how, schema=kw["schema"],
        right_schema=kw["right_schema"],
        engine=kw["engine"], backend=kw["backend"],
        dialect=kw["dialect"], sample=kw["sample"],
        device=kw["device"],
    )
    l_names = set(ln)

    def _frame_col(ref: str) -> str:
        side, col = _split_qualified(ref, l_alias, r_alias)
        if side == "l":
            if col not in l_names:
                raise SqlError(f"no column {col!r} in {l_alias!r}")
            return col
        if side == "r":
            suffixed = col + "_right"
            if suffixed in fr._columns:
                return suffixed
            if col in fr._columns and col not in l_names:
                return col
            raise SqlError(f"no column {col!r} in {r_alias!r}")
        if col in fr._columns:
            return col
        raise SqlError(f"no column {col!r} in the joined result")

    return _run_over_frame(ast, fr, _frame_col, kw["device"], what="JOIN")


def _run_over_frame(ast: _Ast, fr, resolve, device, what: str = "JOIN"):
    """Execute the post-materialization relational pipeline over a
    host Frame: WHERE (host twins of the device leaves), GROUP BY /
    aggregates (exact host reduce), projection, ORDER BY, LIMIT.
    Shared by joined frames and derived tables (FROM (SELECT ...))."""
    if ast.where is not None:
        mask = _frame_mask(fr, ast.where, resolve)
        fr = fr.take(np.flatnonzero(mask))
    has_agg = any(it.kind == "agg" for it in ast.items)
    if ast.group_by or (ast.distinct and not has_agg):
        return _run_join_groupby(ast, fr, resolve)
    if has_agg:
        if ast.having is not None:
            raise SqlError("HAVING needs GROUP BY")
        return _frame_scalar_aggs(ast, fr, resolve)
    if ast.having is not None:
        raise SqlError("HAVING needs GROUP BY")
    star_count = sum(1 for it in ast.items if it.kind == "star")
    if star_count and len(ast.items) > star_count:
        # SELECT *, extra: the star expands to every frame column
        items = []
        for it in ast.items:
            if it.kind == "star":
                items.extend(_Item("col", col=n) for n in fr.names)
            else:
                items.append(it)
    elif star_count:
        items = None  # pure star: the frame as-is
    else:
        items = ast.items
    # project BEFORE ordering so ORDER BY can reference output aliases
    # (incl. COALESCE results); non-projected columns still order via
    # the source frame — both share row order until the sort
    proj = (None if items is None
            else _project_items(fr, items, resolve, device))
    if ast.order_by:
        for it, _ in ast.order_by:
            if it.kind not in ("col", "expr", "fold"):
                raise SqlError(
                    f"ORDER BY aggregates over a {what} is not "
                    "supported"
                )

        def _order_ref(it):
            if it.kind == "col":
                return it.col
            nm = it.name()
            if proj is not None and nm in proj._columns:
                return nm
            return it  # computed on demand against the source frame

        def _order_col(ref):
            if isinstance(ref, _Item):
                if ref.kind == "fold":
                    vals, okm, _c = _fold_column(fr, ref, resolve)
                else:
                    vals, okm, _c = _expr_column(fr, ref.expr,
                                                 resolve)
                return vals, okm
            if proj is not None and ref in proj._columns:
                return proj._columns[ref], proj._ok[ref]
            name = resolve(ref)
            return fr._columns[name], fr._ok[name]

        from .query import _host_multi_order_perm

        perm = _host_multi_order_perm(
            len(fr), _order_col,
            [(_order_ref(it), d) for it, d in ast.order_by],
        )
        fr = fr.take(perm)
        proj = None if proj is None else proj.take(perm)
    out = fr if proj is None else proj
    if ast.limit is not None or ast.offset:
        lo = min(ast.offset, len(out))
        hi = (len(out) if ast.limit is None
              else min(lo + ast.limit, len(out)))
        out = out.take(np.arange(lo, hi))
    return out


def _frame_mask(fr, expr, resolve) -> np.ndarray:
    """Evaluate a where tree on a materialized Frame (host) with the
    same semantics as the device leaves: rows whose column failed its
    typed parse never satisfy a comparison; NOT is a set complement."""
    if isinstance(expr, tuple) and len(expr) == 3 \
            and isinstance(expr[1], str):
        return _frame_leaf(fr, expr, resolve)
    if isinstance(expr, tuple) and len(expr) == 2 \
            and expr[0] in ("and", "or"):
        parts = [_frame_mask(fr, e, resolve) for e in expr[1]]
        if not parts:
            raise SqlError(f"empty {expr[0]!r} expression")
        out = parts[0]
        for p in parts[1:]:
            out = (out & p) if expr[0] == "and" else (out | p)
        return out
    if isinstance(expr, tuple) and len(expr) == 2 and expr[0] == "not":
        return ~_frame_mask(fr, expr[1], resolve)
    if isinstance(expr, list):
        out = None
        for e in expr:
            m = _frame_mask(fr, e, resolve)
            out = m if out is None else (out & m)
        if out is None:
            raise SqlError("empty where list")
        return out
    raise SqlError(f"bad where expression: {expr!r}")


def _ascii_fold(t: str, fn: str) -> str:
    """ASCII-only case fold (A-Z/a-z), matching the device fold — NOT
    str.upper/lower, which also fold non-ASCII letters the device
    leaves alone."""
    if fn == "upper":
        return t.translate(_ASCII_UPPER_TAB)
    return t.translate(_ASCII_LOWER_TAB)


_ASCII_UPPER_TAB = str.maketrans(
    "abcdefghijklmnopqrstuvwxyz", "ABCDEFGHIJKLMNOPQRSTUVWXYZ")
_ASCII_LOWER_TAB = str.maketrans(
    "ABCDEFGHIJKLMNOPQRSTUVWXYZ", "abcdefghijklmnopqrstuvwxyz")


def _host_like(texts, pat, esc, fold=None) -> np.ndarray:
    """Host LIKE over decoded text (the joined-frame twin of
    query._like_pattern_mask): the compiled segments become a regex —
    `_` -> `.`, segment gaps (`%`) -> `.*`, unanchored ends -> `.*`.
    Host `_` matches one CHARACTER where the device matches one BYTE
    (differs only on multi-byte UTF-8)."""
    import re

    from .query import _compile_like

    a_start, a_end, segs = _compile_like(pat, esc)
    parts = []
    for b, wl in segs:
        txt = b.decode("utf-8", "surrogateescape")
        parts.append("".join(
            "." if w else re.escape(c) for c, w in zip(txt, wl)))
    body = ".*".join(parts)
    rx = re.compile(
        ("" if a_start else ".*") + body + ("" if a_end else ".*"),
        re.S)
    if fold is not None:
        return np.array(
            [rx.fullmatch(_ascii_fold(t, fold)) is not None
             for t in texts], bool)
    return np.array([rx.fullmatch(t) is not None for t in texts], bool)


def _frame_leaf(fr, leaf, resolve) -> np.ndarray:
    from .query import TextFold, VExpr, _typed_literal

    col_ref, op, lit = leaf
    if op == "in_rows":
        # composite-key IN over a materialized frame (host twin of
        # query._in_rows_mask; multi-key correlated EXISTS rewrite)
        from .query import rows_in_mask

        cols, oks = [], []
        for c in col_ref:
            nm = resolve(c)
            cols.append(np.asarray(fr._columns[nm], object)
                        if fr.schema[nm].type in ("str", "bytes")
                        else np.asarray(fr._columns[nm]))
            oks.append(fr._ok[nm])
        return rows_in_mask(cols, oks, lit)
    if isinstance(col_ref, TextFold):
        # case-folded text predicate over a materialized frame (host
        # twin of the device fold in query._predicate_mask)
        fold = col_ref.fn
        name = resolve(col_ref.col)
        col = fr.schema[name]
        if col.type not in ("str", "bytes"):
            raise SqlError(
                f"UPPER()/LOWER() fold decoded text; {name!r} is "
                f"{col.type} (give an explicit str/bytes schema)"
            )
        vals = fr._columns[name]
        okm = fr._ok[name]
        ok = (np.ones(len(fr), bool) if okm is None
              else np.asarray(okm, bool))
        txt = [_ascii_fold(
            v if isinstance(v, str)
            else v.decode("utf-8", "surrogateescape"), fold)
            for v in vals]
        if op == "like":
            pat, esc = lit if isinstance(lit, tuple) else (lit, None)
            # pattern folds per segment inside _host_like via fold=...
            return ok & _host_like(txt, pat, esc, fold=fold)
        if op in ("startswith", "endswith", "contains"):
            pat = _ascii_fold(lit if isinstance(lit, str) else str(lit),
                              fold)
            f = {"startswith": str.startswith, "endswith": str.endswith,
                 "contains": str.__contains__}[op]
            return ok & np.array([f(t, pat) for t in txt], bool)
        if op in ("==", "!="):
            pat = _ascii_fold(lit if isinstance(lit, str) else str(lit),
                              fold)
            eq = np.array([t == pat for t in txt], bool)
            return ok & (eq if op == "==" else ~eq)
        if op == "in":
            pats = {_ascii_fold(p if isinstance(p, str) else str(p),
                                fold) for p in lit}
            return ok & np.array([t in pats for t in txt], bool)
        raise SqlError(
            f"op {op!r} does not apply to UPPER()/LOWER()")
    if isinstance(col_ref, VExpr):
        # arithmetic comparison over the joined frame (host twin of
        # query._vexpr_cmp_mask; same int32/float32/0-div semantics)
        va, oka, _ = _expr_column(fr, col_ref, resolve)
        rhs = lit if isinstance(lit, VExpr) else VExpr(("lit", lit))
        vb, okb, _ = _expr_column(fr, rhs, resolve)
        n = len(fr)
        oa = np.ones(n, bool) if oka is None else oka
        ob = np.ones(n, bool) if okb is None else okb
        import operator as _oper

        f = {"==": _oper.eq, "!=": _oper.ne, "<": _oper.lt,
             "<=": _oper.le, ">": _oper.gt, ">=": _oper.ge}[op]
        return oa & ob & f(np.asarray(va, np.float64),
                           np.asarray(vb, np.float64))
    name = resolve(col_ref)
    col = fr.schema[name]
    vals = fr._columns[name]
    okm = fr._ok[name]
    ok = np.ones(len(fr), bool) if okm is None else np.asarray(okm, bool)
    if op in ("isnull", "notnull"):
        # over a join, absent-side rows are not-ok too — IS NULL sees
        # both parse failures and unmatched rows, like SQL
        return ~ok if op == "isnull" else ok
    if col.type in ("str", "bytes"):
        txt = [v if isinstance(v, str)
               else v.decode("utf-8", "surrogateescape") for v in vals]
        if op in ("startswith", "endswith", "contains"):
            pat = lit if isinstance(lit, str) else str(lit)
            f = {"startswith": str.startswith, "endswith": str.endswith,
                 "contains": str.__contains__}[op]
            return ok & np.array([f(t, pat) for t in txt], bool)
        if op in ("==", "!="):
            pat = lit if isinstance(lit, str) else str(lit)
            eq = np.array([t == pat for t in txt], bool)
            return ok & (eq if op == "==" else ~eq)
        if op == "in":
            pats = {p if isinstance(p, str) else str(p) for p in lit}
            return ok & np.array([t in pats for t in txt], bool)
        if op == "between":
            lo, hi = (str(lit[0]), str(lit[1]))
            return ok & np.array([lo <= t <= hi for t in txt], bool)
        raise SqlError(f"op {op!r} needs a typed column; {name!r} is text")
    if op in ("startswith", "endswith", "contains"):
        raise SqlError(f"op {op!r} needs a text column; {name!r} is "
                       f"{col.type}")
    v = np.asarray(vals)

    def _lit(x):
        # frame date/datetime columns materialize as datetime64; the
        # epoch ints _typed_literal returns must convert to the same
        # dtype or numpy comparisons raise
        y = _typed_literal(col, x)
        if col.type == "date":
            return np.datetime64(int(y), "D")
        if col.type == "datetime":
            return np.datetime64(int(y), col.unit)
        return y

    import operator as _op

    cmp_fn = {"==": _op.eq, "!=": _op.ne, "<": _op.lt, "<=": _op.le,
              ">": _op.gt, ">=": _op.ge}
    if op == "between":
        return ok & (v >= _lit(lit[0])) & (v <= _lit(lit[1]))
    if op == "in":
        m = np.zeros(len(fr), bool)
        for x in lit:
            m |= (v == _lit(x))
        return ok & m
    return ok & np.asarray(cmp_fn[op](v, _lit(lit)), bool)


def _order_frame(fr, order):
    from .query import _host_multi_order_perm

    perm = _host_multi_order_perm(
        len(fr), lambda n: (fr._columns[n], fr._ok[n]), order)
    return fr.take(perm)
