"""EVM operand stack, max depth 1024 (vm/Stack.scala:50).

Words are plain ints (see dataword.py). Over/underflow raise — the VM
translates them into StackOverflow/StackUnderflow program errors before
any state is touched.
"""

from __future__ import annotations

from typing import List

MAX_DEPTH = 1024


class StackError(Exception):
    pass


class Stack:
    __slots__ = ("items",)

    def __init__(self, items: List[int] = None):
        self.items = items if items is not None else []

    def push(self, x: int) -> None:
        if len(self.items) >= MAX_DEPTH:
            raise StackError("stack overflow")
        self.items.append(x)

    def pop(self) -> int:
        if not self.items:
            raise StackError("stack underflow")
        return self.items.pop()

    def pop_n(self, n: int) -> List[int]:
        if len(self.items) < n:
            raise StackError("stack underflow")
        out = self.items[-n:][::-1]
        del self.items[-n:]
        return out

    def peek(self, depth: int = 0) -> int:
        if len(self.items) <= depth:
            raise StackError("stack underflow")
        return self.items[-1 - depth]

    def dup(self, i: int) -> None:
        """DUP1..DUP16: duplicate the i-th item from the top (1-based)."""
        if len(self.items) < i:
            raise StackError("stack underflow")
        if len(self.items) >= MAX_DEPTH:
            raise StackError("stack overflow")
        self.items.append(self.items[-i])

    def swap(self, i: int) -> None:
        """SWAP1..SWAP16: swap top with the (i+1)-th item."""
        if len(self.items) < i + 1:
            raise StackError("stack underflow")
        self.items[-1], self.items[-1 - i] = self.items[-1 - i], self.items[-1]

    def __len__(self) -> int:
        return len(self.items)
