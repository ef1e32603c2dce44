"""Runtime math-expression language, compiled to JAX-traceable callables.

Replaces the reference's stack-bytecode interpreter (``m_fparser.f90``) with a
compile-once design: an expression string is parsed to an AST a single time
(the reference re-parses every function on every timestep — m_fparser.f90:135,
EC3D.f90:246-253) and evaluated with ``jax.numpy`` ops so that source values
become part of the traced/jitted step function.

Function set and semantics match the reference VM (m_fparser.f90:33-104,
158-241):

=========  =============================================================
name       meaning
=========  =============================================================
abs        absolute value
exp        e**x
lg         log10(x); returns 0 for x <= 0 (EvalErrType=3 path)
ln         natural log
sqrt       square root
sh/ch/th   sinh / cosh / tanh
cth        coth = cosh/sinh
sind/cosd  sine / cosine in DEGREES
tgd        tangent in DEGREES
sin/cos/tg sine / cosine / tangent (radians)
asin/acos  returns 0 when |x| > 1 (EvalErrType=4 path)
atg        arctangent
impls      unit step:  1 if x > 0 else 0          (cU)
impl2      sign step:  1 if x >= 0 else -1        (cU2)
pos        ramp: x if x > 0 else 0                (cPos)
int        truncate toward zero (Fortran AINT)
nint       round half away from zero (Fortran ANINT)
floor/ceil floor / ceiling
=========  =============================================================

Binary ops: ``+ - * / ^`` (and ``**`` as a synonym for ``^``); division by
zero yields 0 (the VM aborts evaluation with result 0, m_fparser.f90:180).
Power is right-associative like the reference's recursive compile.
Identifiers are case-insensitive.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

import jax.numpy as jnp
import numpy as _np

__all__ = ["Expression", "compile_expression", "ExprError"]


class ExprError(ValueError):
    """Raised on a malformed expression string."""


_TOKEN_RE = re.compile(
    r"\s*(?:"
    r"(?P<num>(?:\d+\.?\d*|\.\d+)(?:[eEdD][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z0-9_]*)"
    r"|(?P<op>\*\*|[-+*/^()])"
    r")"
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens: list[tuple[str, str]] = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None or m.end() == pos:
            rest = text[pos:].strip()
            if not rest:
                break
            raise ExprError(f"cannot tokenize {text!r} at {rest[:10]!r}")
        pos = m.end()
        if m.lastgroup == "num":
            tokens.append(("num", m.group("num").lower().replace("d", "e")))
        elif m.lastgroup == "name":
            tokens.append(("name", m.group("name").upper()))
        else:
            op = m.group("op")
            tokens.append(("op", "^" if op == "**" else op))
    tokens.append(("end", ""))
    return tokens


# --- AST ------------------------------------------------------------------

@dataclass(frozen=True)
class _Num:
    value: float


@dataclass(frozen=True)
class _Var:
    name: str


@dataclass(frozen=True)
class _Un:
    op: str
    arg: object


@dataclass(frozen=True)
class _Bin:
    op: str
    lhs: object
    rhs: object


@dataclass(frozen=True)
class _Call:
    fn: str
    arg: object


_DEG = math.pi / 180.0


def _safe_div(a, b):
    b = jnp.asarray(b, dtype=jnp.result_type(float, a, b))
    zero = b == 0
    return jnp.where(zero, 0.0, jnp.asarray(a) / jnp.where(zero, 1.0, b))


def _anint(x):
    # Fortran ANINT: round half away from zero (jnp.round is half-to-even).
    x = jnp.asarray(x)
    return jnp.trunc(x + jnp.where(x >= 0, 0.5, -0.5))


# Host (pure-Python/math) backend: same semantics as the jnp table below.
# Used whenever every operand is a plain scalar — constant-expression folding
# in the .vxc reader must NOT dispatch eager device ops (each eager op pays a
# device dispatch and readback; a model file evaluates hundreds of constants).
def _h_safe_div(a, b):
    return 0.0 if b == 0 else a / b


def _h_anint(x):
    return float(math.trunc(x + (0.5 if x >= 0 else -0.5)))


def _h1(np_fn):
    """Scalar host wrapper over a numpy ufunc: nan/inf on domain errors,
    exactly like the jnp table (math.* would raise instead)."""

    def call(x):
        with _np.errstate(all="ignore"):
            return float(np_fn(_np.float64(x)))

    return call


_HOST_FUNCS: dict[str, Callable] = {
    "ABS": lambda x: float(abs(x)),
    "EXP": _h1(_np.exp),
    "LG": lambda x: float(_np.log10(_np.float64(x))) if x > 0 else 0.0,
    "LN": _h1(_np.log),
    "SQRT": _h1(_np.sqrt),
    "SH": _h1(_np.sinh),
    "CH": _h1(_np.cosh),
    "TH": _h1(_np.tanh),
    "CTH": lambda x: _h_safe_div(math.cosh(x), math.sinh(x)),
    "SIND": lambda x: math.sin(x * _DEG),
    "COSD": lambda x: math.cos(x * _DEG),
    "TGD": lambda x: math.tan(x * _DEG),
    "SIN": math.sin,
    "COS": math.cos,
    "TG": math.tan,
    "ASIN": lambda x: math.asin(max(-1.0, min(1.0, x))) if abs(x) <= 1 else 0.0,
    "ACOS": lambda x: math.acos(max(-1.0, min(1.0, x))) if abs(x) <= 1 else 0.0,
    "IMPLS": lambda x: 1.0 if x > 0 else 0.0,
    "IMPL2": lambda x: 1.0 if x >= 0 else -1.0,
    "POS": lambda x: x if x > 0 else 0.0,
    "INT": lambda x: float(math.trunc(x)),
    "NINT": _h_anint,
    "FLOOR": lambda x: float(math.floor(x)),
    "CEIL": lambda x: float(math.ceil(x)),
    "ATG": math.atan,
}


_FUNCS: dict[str, Callable] = {
    "ABS": jnp.abs,
    "EXP": jnp.exp,
    "LG": lambda x: jnp.where(jnp.asarray(x) > 0, jnp.log10(jnp.where(jnp.asarray(x) > 0, x, 1.0)), 0.0),
    "LN": jnp.log,
    "SQRT": jnp.sqrt,
    "SH": jnp.sinh,
    "CH": jnp.cosh,
    "TH": jnp.tanh,
    "CTH": lambda x: _safe_div(jnp.cosh(x), jnp.sinh(x)),
    "SIND": lambda x: jnp.sin(jnp.asarray(x) * _DEG),
    "COSD": lambda x: jnp.cos(jnp.asarray(x) * _DEG),
    "TGD": lambda x: jnp.tan(jnp.asarray(x) * _DEG),
    "SIN": jnp.sin,
    "COS": jnp.cos,
    "TG": jnp.tan,
    "ASIN": lambda x: jnp.where(jnp.abs(jnp.asarray(x)) <= 1, jnp.arcsin(jnp.clip(x, -1, 1)), 0.0),
    "ACOS": lambda x: jnp.where(jnp.abs(jnp.asarray(x)) <= 1, jnp.arccos(jnp.clip(x, -1, 1)), 0.0),
    "IMPLS": lambda x: jnp.where(jnp.asarray(x) > 0, 1.0, 0.0),
    "IMPL2": lambda x: jnp.where(jnp.asarray(x) >= 0, 1.0, -1.0),
    "POS": lambda x: jnp.where(jnp.asarray(x) > 0, x, 0.0),
    "INT": jnp.trunc,
    "NINT": _anint,
    "FLOOR": jnp.floor,
    "CEIL": jnp.ceil,
    "ATG": jnp.arctan,
}


class _Parser:
    """Recursive-descent: expr := term (('+'|'-') term)*; term := factor
    (('*'|'/') factor)*; factor := ['-'|'+'] power; power := atom ['^' factor].
    """

    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def peek(self):
        return self.tokens[self.i]

    def next(self):
        tok = self.tokens[self.i]
        self.i += 1
        return tok

    def expect_op(self, op: str):
        kind, val = self.next()
        if kind != "op" or val != op:
            raise ExprError(f"expected {op!r}, got {val!r}")

    def parse(self):
        node = self.expr()
        if self.peek()[0] != "end":
            raise ExprError(f"trailing input at {self.peek()[1]!r}")
        return node

    def expr(self):
        node = self.term()
        while self.peek() == ("op", "+") or self.peek() == ("op", "-"):
            _, op = self.next()
            node = _Bin(op, node, self.term())
        return node

    def term(self):
        node = self.factor()
        while self.peek() == ("op", "*") or self.peek() == ("op", "/"):
            _, op = self.next()
            node = _Bin(op, node, self.factor())
        return node

    def factor(self):
        if self.peek() == ("op", "-"):
            self.next()
            return _Un("-", self.factor())
        if self.peek() == ("op", "+"):
            self.next()
            return self.factor()
        return self.power()

    def power(self):
        node = self.atom()
        if self.peek() == ("op", "^"):
            self.next()
            # right-associative; exponent may carry its own unary sign
            node = _Bin("^", node, self.factor())
        return node

    def atom(self):
        kind, val = self.next()
        if kind == "num":
            return _Num(float(val))
        if kind == "name":
            if self.peek() == ("op", "("):
                if val not in _FUNCS:
                    raise ExprError(f"unknown function {val!r}")
                self.next()
                arg = self.expr()
                self.expect_op(")")
                return _Call(val, arg)
            return _Var(val)
        if (kind, val) == ("op", "("):
            node = self.expr()
            self.expect_op(")")
            return node
        raise ExprError(f"unexpected token {val!r}")


def _free_vars(node, out: set[str]):
    if isinstance(node, _Var):
        out.add(node.name)
    elif isinstance(node, _Un):
        _free_vars(node.arg, out)
    elif isinstance(node, _Bin):
        _free_vars(node.lhs, out)
        _free_vars(node.rhs, out)
    elif isinstance(node, _Call):
        _free_vars(node.arg, out)


def _eval(node, env: Mapping[str, object], host: bool = False):
    if isinstance(node, _Num):
        return node.value
    if isinstance(node, _Var):
        try:
            return env[node.name]
        except KeyError:
            raise ExprError(f"unbound variable {node.name!r}") from None
    if isinstance(node, _Un):
        return -_eval(node.arg, env, host)
    if isinstance(node, _Bin):
        a = _eval(node.lhs, env, host)
        b = _eval(node.rhs, env, host)
        if node.op == "+":
            return a + b
        if node.op == "-":
            return a - b
        if node.op == "*":
            return a * b
        if node.op == "/":
            return _h_safe_div(a, b) if host else _safe_div(a, b)
        if host:
            with _np.errstate(all="ignore"):
                return float(_np.power(_np.float64(a), _np.float64(b)))
        if isinstance(a, float) and isinstance(b, float):
            return a ** b
        return jnp.power(a, b)
    if isinstance(node, _Call):
        table = _HOST_FUNCS if host else _FUNCS
        return table[node.fn](_eval(node.arg, env, host))
    raise TypeError(node)


def _all_host_scalars(env: Mapping[str, object], names: frozenset[str]) -> bool:
    for k in names:
        v = env.get(k)
        if v is None:
            continue
        if not isinstance(v, (int, float, _np.integer, _np.floating)):
            return False
    return True


@dataclass(frozen=True)
class Expression:
    """A compiled expression. Call with a variable environment (uppercase
    names). Values may be Python floats or (traced) jnp scalars."""

    source: str
    root: object
    variables: frozenset[str]

    def __call__(self, env: Mapping[str, object] | None = None, **kwargs):
        merged = {k.upper(): v for k, v in (env or {}).items()}
        merged.update({k.upper(): v for k, v in kwargs.items()})
        # Constant folding (all plain scalars) runs on the host — an eager
        # device op pays a dispatch and readback each. Traced/array operands
        # take the jnp path so calls inside jit stay part of the graph.
        if _all_host_scalars(merged, self.variables):
            return _eval(self.root, merged, host=True)
        return _eval(self.root, merged)


def compile_expression(text: str, variables: Sequence[str] | None = None) -> Expression:
    """Parse ``text`` once into a reusable :class:`Expression`.

    ``variables``, when given, is the allowed variable set (the reference
    passes the explicit argument-name list to ``parsef``); unknown names
    raise :class:`ExprError` at compile time instead of evaluation time.
    """
    root = _Parser(_tokenize(text)).parse()
    free: set[str] = set()
    _free_vars(root, free)
    if variables is not None:
        allowed = {v.strip().upper() for v in variables}
        unknown = free - allowed
        if unknown:
            raise ExprError(f"unknown variable(s) {sorted(unknown)} in {text!r}")
    return Expression(source=text, root=root, variables=frozenset(free))
