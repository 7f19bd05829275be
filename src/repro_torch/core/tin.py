"""Tensor Index Notation (TIN) — the computation language of SpDISTAL.

Paper §II-A: computation is described with TACO-style tensor index notation.
``a(i) = B(i,j) * c(j)`` declares an SpMV; index variables appearing only on
the right-hand side are sum-reduced.

This module defines the TIN AST (accesses, adds, muls, assignment) plus a
string front-end so expressions can be written exactly as in the paper::

    stmt = parse_tin("a(i) = B(i,j) * c(j)", a=a, B=B, c=c)

The AST is deliberately independent of data structures (formats.py),
distribution (tdn.py) and scheduling (schedule.py) — the separation of the
four sub-languages is the paper's first contribution.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple


class IndexVar:
    """A named index variable (paper: ``IndexVar i, j;``)."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return self.name

    def __eq__(self, other: object) -> bool:
        return isinstance(other, IndexVar) and other.name == self.name

    def __hash__(self) -> int:
        return hash(("IndexVar", self.name))


def index_vars(names: str) -> Tuple[IndexVar, ...]:
    """``i, j, k = index_vars("i j k")``"""
    return tuple(IndexVar(n) for n in names.replace(",", " ").split())


class TinExpr:
    """Base class for right-hand-side expressions."""

    def __add__(self, other: "TinExpr") -> "Add":
        return Add(self, _as_expr(other))

    def __radd__(self, other: "TinExpr") -> "Add":
        return Add(_as_expr(other), self)

    def __mul__(self, other: "TinExpr") -> "Mul":
        return Mul(self, _as_expr(other))

    def __rmul__(self, other: "TinExpr") -> "Mul":
        return Mul(_as_expr(other), self)

    # -- traversal helpers -------------------------------------------------
    def accesses(self) -> List["Access"]:
        raise NotImplementedError

    def index_vars(self) -> List[IndexVar]:
        seen: List[IndexVar] = []
        for acc in self.accesses():
            for iv in acc.idx:
                if iv not in seen:
                    seen.append(iv)
        return seen


@dataclasses.dataclass(frozen=True)
class Literal(TinExpr):
    value: float

    def accesses(self) -> List["Access"]:
        return []

    def __repr__(self) -> str:
        return repr(self.value)


def _as_expr(x: Any) -> TinExpr:
    if isinstance(x, TinExpr):
        return x
    if isinstance(x, (int, float)):
        return Literal(float(x))
    raise TypeError(f"cannot coerce {x!r} to a TIN expression")


class Access(TinExpr):
    """``B(i, j)`` — indexes tensor ``B`` with index variables ``(i, j)``.

    ``tensor`` is any object with ``.name``, ``.shape`` and ``.format``
    attributes (core.tensor.Tensor / TensorVar below).
    """

    __slots__ = ("tensor", "idx")

    def __init__(self, tensor: Any, idx: Sequence[IndexVar]):
        if len(idx) != len(tensor.shape):
            raise ValueError(
                f"access {tensor.name}({','.join(map(str, idx))}) has "
                f"{len(idx)} indices but tensor has order {len(tensor.shape)}"
            )
        self.tensor = tensor
        self.idx = tuple(idx)

    def accesses(self) -> List["Access"]:
        return [self]

    def __repr__(self) -> str:
        return f"{self.tensor.name}({','.join(v.name for v in self.idx)})"


@dataclasses.dataclass(frozen=True)
class Add(TinExpr):
    lhs: TinExpr
    rhs: TinExpr

    def accesses(self) -> List[Access]:
        return self.lhs.accesses() + self.rhs.accesses()

    def __repr__(self) -> str:
        return f"{self.lhs} + {self.rhs}"


@dataclasses.dataclass(frozen=True)
class Mul(TinExpr):
    lhs: TinExpr
    rhs: TinExpr

    def accesses(self) -> List[Access]:
        return self.lhs.accesses() + self.rhs.accesses()

    def __repr__(self) -> str:
        return f"{self.lhs} * {self.rhs}"


class Assignment:
    """``lhs = rhs`` (or ``lhs += rhs``) over index variables.

    Free variables (appearing only in rhs) are sum-reduced — the paper's
    semantics for tensor index notation.
    """

    def __init__(self, lhs: Access, rhs: TinExpr, accumulate: bool = False):
        self.lhs = lhs
        self.rhs = _as_expr(rhs)
        self.accumulate = accumulate

    # -- structural queries used by the scheduler / lowerer ----------------
    @property
    def result_vars(self) -> Tuple[IndexVar, ...]:
        return self.lhs.idx

    @property
    def reduction_vars(self) -> Tuple[IndexVar, ...]:
        return tuple(v for v in self.rhs.index_vars() if v not in self.lhs.idx)

    @property
    def all_vars(self) -> Tuple[IndexVar, ...]:
        out = list(self.lhs.idx)
        for v in self.rhs.index_vars():
            if v not in out:
                out.append(v)
        return tuple(out)

    def accesses(self) -> List[Access]:
        return [self.lhs] + self.rhs.accesses()

    def tensors(self) -> List[Any]:
        seen: List[Any] = []
        for acc in self.accesses():
            if acc.tensor not in seen:
                seen.append(acc.tensor)
        return seen

    def sparse_accesses(self) -> List[Access]:
        return [a for a in self.rhs.accesses() if a.tensor.format.is_sparse]

    def with_tensors(self, mapping: Dict[str, Any]) -> "Assignment":
        """A copy of the statement with tensors swapped by name — used by the
        lowering engine's format-conversion fallback (the converted tensor
        replaces the original throughout the AST). Index structure is
        untouched, so the signature and schedule stay valid."""
        if not mapping:
            return self

        def rebuild(e: TinExpr) -> TinExpr:
            if isinstance(e, Access):
                t = mapping.get(e.tensor.name, e.tensor)
                return Access(t, e.idx)
            if isinstance(e, Add):
                return Add(rebuild(e.lhs), rebuild(e.rhs))
            if isinstance(e, Mul):
                return Mul(rebuild(e.lhs), rebuild(e.rhs))
            return e

        lhs = rebuild(self.lhs)
        return Assignment(lhs, rebuild(self.rhs), accumulate=self.accumulate)

    def var_extent(self, v: IndexVar) -> int:
        """Dimension size an index variable ranges over (must be consistent)."""
        ext: Optional[int] = None
        for acc in self.accesses():
            for axis, iv in enumerate(acc.idx):
                if iv == v:
                    d = acc.tensor.shape[axis]
                    if ext is not None and ext != d:
                        raise ValueError(
                            f"index var {v} ranges over inconsistent extents "
                            f"{ext} vs {d}"
                        )
                    ext = d
        if ext is None:
            raise KeyError(f"index var {v} not used in statement")
        return ext

    def signature(self) -> str:
        """Canonical signature used to pick a specialized leaf kernel.

        E.g. SpMV ``a(i)=B(i,j)*c(j)`` with B sparse →
        ``"d1(i)=s2(i,j)*d1(j)"``.
        """

        def fmt_access(acc: Access) -> str:
            kind = "s" if acc.tensor.format.is_sparse else "d"
            return f"{kind}{len(acc.tensor.shape)}({','.join(v.name for v in acc.idx)})"

        def fmt_expr(e: TinExpr) -> str:
            if isinstance(e, Access):
                return fmt_access(e)
            if isinstance(e, Add):
                return f"{fmt_expr(e.lhs)}+{fmt_expr(e.rhs)}"
            if isinstance(e, Mul):
                return f"{fmt_expr(e.lhs)}*{fmt_expr(e.rhs)}"
            if isinstance(e, Literal):
                return "lit"
            raise TypeError(type(e))

        return f"{fmt_access(self.lhs)}={fmt_expr(self.rhs)}"

    def __repr__(self) -> str:
        op = "+=" if self.accumulate else "="
        return f"{self.lhs} {op} {self.rhs}"


# ---------------------------------------------------------------------------
# String front-end: parse "a(i) = B(i,j) * c(j)" given tensor bindings.
# ---------------------------------------------------------------------------

_ACCESS_RE = re.compile(r"([A-Za-z_]\w*)\s*\(\s*([\w\s,]*?)\s*\)")


def parse_tin(src: str, **tensors: Any) -> Assignment:
    """Parse a TIN statement string into an :class:`Assignment`.

    Supports ``=`` / ``+=`` assignment, ``+`` and ``*`` with standard
    precedence, and parenthesised sub-expressions.
    """
    if "+=" in src:
        lhs_src, rhs_src = src.split("+=", 1)
        accumulate = True
    else:
        lhs_src, rhs_src = src.split("=", 1)
        accumulate = False

    ivars: Dict[str, IndexVar] = {}

    def get_ivar(name: str) -> IndexVar:
        if name not in ivars:
            ivars[name] = IndexVar(name)
        return ivars[name]

    def parse_access(m: re.Match) -> Access:
        tname, idx_src = m.group(1), m.group(2)
        if tname not in tensors:
            raise KeyError(f"tensor {tname!r} not bound (pass {tname}=<tensor>)")
        idx = [get_ivar(s.strip()) for s in idx_src.split(",") if s.strip()]
        return Access(tensors[tname], idx)

    # Tokenize rhs: accesses, + * ( ) literals.
    tokens: List[Any] = []
    pos = 0
    s = rhs_src.strip()
    while pos < len(s):
        ch = s[pos]
        if ch.isspace():
            pos += 1
            continue
        if ch in "+*()":
            tokens.append(ch)
            pos += 1
            continue
        m = _ACCESS_RE.match(s, pos)
        if m:
            tokens.append(parse_access(m))
            pos = m.end()
            continue
        mnum = re.match(r"\d+(\.\d+)?", s[pos:])
        if mnum:
            tokens.append(Literal(float(mnum.group(0))))
            pos += mnum.end()
            continue
        raise SyntaxError(f"cannot tokenize TIN at: {s[pos:]!r}")

    # Recursive-descent: expr := term ('+' term)*; term := factor ('*' factor)*
    idx = 0

    def peek() -> Any:
        return tokens[idx] if idx < len(tokens) else None

    def parse_factor() -> TinExpr:
        nonlocal idx
        t = peek()
        if t == "(":
            idx += 1
            e = parse_expr()
            if peek() != ")":
                raise SyntaxError("unbalanced parens in TIN expression")
            idx += 1
            return e
        if isinstance(t, (Access, Literal)):
            idx += 1
            return t
        raise SyntaxError(f"unexpected token {t!r}")

    def parse_term() -> TinExpr:
        nonlocal idx
        e = parse_factor()
        while peek() == "*":
            idx += 1
            e = Mul(e, parse_factor())
        return e

    def parse_expr() -> TinExpr:
        nonlocal idx
        e = parse_term()
        while peek() == "+":
            idx += 1
            e = Add(e, parse_term())
        return e

    rhs = parse_expr()
    if idx != len(tokens):
        raise SyntaxError(f"trailing tokens in TIN expression: {tokens[idx:]}")

    lm = _ACCESS_RE.search(lhs_src)
    if lm is None:
        raise SyntaxError(f"cannot parse TIN lhs: {lhs_src!r}")
    lhs = parse_access(lm)
    return Assignment(lhs, rhs, accumulate=accumulate)
