"""A small evaluator of the C++ integer expressions the CUDA sources size
their shared memory with: literals, names, `sizeof`, C-style casts,
`min` / `max` (also `std::`), `Struct<T>::NAME`,
`fn<T>()` of a constexpr function, unary and binary arithmetic,
comparisons, `&&` / `||` and `?:`. Division and remainder are C's
integer ones. A name the environment does not hold raises `Unresolved`.
"""
from __future__ import annotations

import functools
import re

__all__ = ["Unresolved", "evaluate", "names_in", "TYPE_BYTES"]

TYPE_BYTES = {"float": 4, "int": 4, "unsigned": 4, "uint32_t": 4,
              "int32_t": 4, "uint64_t": 8, "int64_t": 8, "size_t": 8,
              "double": 8, "char": 1, "int8_t": 1, "uint8_t": 1,
              "unsigned char": 1, "uint16_t": 2, "int16_t": 2, "short": 2,
              "__half": 2, "__nv_bfloat16": 2, "half": 2, "bool": 1,
              "uint4": 16, "float4": 16, "float2": 8, "uintptr_t": 8}
_CASTS = ("size_t", "int", "unsigned", "uint32_t", "int64_t", "uint64_t",
          "long", "float", "double", "uint16_t", "int32_t")
_TOKEN = re.compile(r"\s*(?:(\d+)[uUlL]*|([A-Za-z_]\w*(?:::\w+)*)|"
                    r"(<<|>>|<=|>=|==|!=|&&|\|\||::|[-+*/%<>()?:,!&|^~]))")


class Unresolved(ValueError):
    """The expression names something the evaluator cannot resolve."""


@functools.lru_cache(maxsize=4096)
def _tokens(text: str) -> tuple:
    out, pos = [], 0
    text = text.strip()
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m or m.end() == pos:
            raise Unresolved(f"cannot read {text[pos:]!r}")
        if m.group(1) is not None:
            out.append(("num", int(m.group(1))))
        elif m.group(2) is not None:
            out.append(("name", m.group(2)))
        else:
            out.append(("op", m.group(3)))
        pos = m.end()
    return tuple(out)


_BIN = {"||": 1, "&&": 2, "|": 3, "^": 4, "&": 5, "==": 6, "!=": 6,
        "<": 7, ">": 7, "<=": 7, ">=": 7, "<<": 8, ">>": 8, "+": 9,
        "-": 9, "*": 10, "/": 10, "%": 10}


def _cdiv(a, b):
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


_OPS = {"||": lambda a, b: int(bool(a) or bool(b)),
        "&&": lambda a, b: int(bool(a) and bool(b)),
        "|": lambda a, b: a | b, "^": lambda a, b: a ^ b,
        "&": lambda a, b: a & b, "==": lambda a, b: int(a == b),
        "!=": lambda a, b: int(a != b), "<": lambda a, b: int(a < b),
        ">": lambda a, b: int(a > b), "<=": lambda a, b: int(a <= b),
        ">=": lambda a, b: int(a >= b), "<<": lambda a, b: a << b,
        ">>": lambda a, b: a >> b, "+": lambda a, b: a + b,
        "-": lambda a, b: a - b, "*": lambda a, b: a * b,
        "/": _cdiv, "%": lambda a, b: a - _cdiv(a, b) * b}


class _Parser:
    def __init__(self, text, env, types, memo):
        self.toks = _tokens(text)
        self.i = 0
        self.env = env          # name -> int, or str (an expression)
        self.types = types      # type name -> bytes (T bound here)
        self.memo = memo        # name -> its value in this evaluation

    def peek(self, k=0):
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else ("end", None)

    def take(self, want=None):
        tok = self.peek()
        if want is not None and tok[1] != want:
            raise Unresolved(f"expected {want!r}, got {tok[1]!r}")
        self.i += 1
        return tok

    def parse(self):
        v = self.expr(0)
        if self.peek()[0] != "end":
            raise Unresolved(f"trailing {self.peek()[1]!r}")
        return v

    def expr(self, prec):
        left = self.unary()
        while True:
            kind, op = self.peek()
            if kind == "op" and op == "?" and prec == 0:
                self.take()
                a = self.expr(0)
                self.take(":")
                b = self.expr(0)
                left = a if left else b
                continue
            if kind != "op" or op not in _BIN or _BIN[op] <= prec:
                return left
            self.take()
            right = self.expr(_BIN[op])
            left = _OPS[op](left, right)

    def unary(self):
        kind, v = self.peek()
        if kind == "op" and v in "-+!~":
            self.take()
            x = self.unary()
            return {"-": -x, "+": x, "!": int(not x), "~": ~x}[v]
        if kind == "op" and v == "(":
            # a C cast: (type) x
            nk, nv = self.peek(1)
            if nk == "name" and nv in _CASTS and self.peek(2)[1] == ")":
                self.i += 3
                return self.unary()
            self.take()
            x = self.expr(0)
            self.take(")")
            return x
        return self.primary()

    def args(self):
        self.take("(")
        out = []
        while self.peek()[1] != ")":
            out.append(self.expr(0))
            if self.peek()[1] == ",":
                self.take()
        self.take(")")
        return out

    def template_args(self):
        """Skip `<...>` after a name (template arguments)."""
        depth = 0
        while True:
            _, v = self.take()
            depth += {"<": 1, ">": -1, ">>": -2}.get(v, 0)
            if depth <= 0:
                return

    def primary(self):
        kind, v = self.take()
        if kind == "num":
            return v
        if kind != "name":
            raise Unresolved(f"unexpected {v!r}")
        name = v
        if name == "sizeof":
            self.take("(")
            parts = []
            while self.peek()[1] != ")":
                parts.append(str(self.take()[1]))
            self.take(")")
            t = " ".join(parts)
            if t not in self.types:
                raise Unresolved(f"sizeof({t})")
            return self.types[t]
        if self.peek()[1] == "<" and self._struct_like(name):
            self.template_args()
            if self.peek()[1] == "::":
                self.take()
                name = f"{name}<>::{self.take()[1]}"
            elif self.peek()[1] == "(":
                self.args()
                return self.lookup(f"{name}<>()")
            else:
                return self.lookup(f"{name}<>")
        if self.peek()[1] == "(":
            args = self.args()
            if name in ("min", "std::min") and args:
                return min(args)
            if name in ("max", "std::max") and args:
                return max(args)
            return self.lookup(f"{name}()")
        return self.lookup(name)

    def _struct_like(self, name):
        return any(k.startswith(f"{name}<>") for k in self.env)

    def lookup(self, name):
        if name not in self.env:
            raise Unresolved(name)
        if name not in self.memo:
            v = self.env[name]
            self.memo[name] = _Parser(v, self.env, self.types,
                                      self.memo).parse() \
                if isinstance(v, str) else v
        return self.memo[name]


def evaluate(text: str, env: dict, types: dict = None) -> int:
    """The value of C expression `text`; env maps names to ints or to
    expression strings (evaluated in the same env), `Struct<>::NAME` and
    `fn<>()` included; types maps type names to sizes (TYPE_BYTES and
    T's binding)."""
    return _Parser(text, env, {**TYPE_BYTES, **(types or {})}, {}).parse()


def names_in(text: str, env: dict) -> set:
    """Every name `text` reaches, through the env's expressions."""
    seen, stack = set(), [text]
    while stack:
        for kind, v in _tokens(stack.pop()):
            if kind == "name" and v not in seen:
                seen.add(v)
                if isinstance(env.get(v), str):
                    stack.append(env[v])
    return seen
