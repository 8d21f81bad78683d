"""Program = immutable code buffer + jumpdest analysis (vm/Program.scala:13).

Valid JUMPDESTs are positions of byte 0x5B *not* inside PUSH data; the
set is computed once per code blob and cached on the instance.
"""

from __future__ import annotations

from functools import cached_property

PUSH1, PUSH32 = 0x60, 0x7F
JUMPDEST = 0x5B


class Program:
    __slots__ = ("code", "__dict__")

    def __init__(self, code: bytes):
        self.code = code

    def byte_at(self, pc: int) -> int:
        """Past-the-end reads are STOP (0x00)."""
        if 0 <= pc < len(self.code):
            return self.code[pc]
        return 0

    def slice(self, offset: int, size: int) -> bytes:
        """Zero-padded code read (CODECOPY semantics)."""
        chunk = self.code[offset : offset + size]
        return chunk + b"\x00" * (size - len(chunk))

    @cached_property
    def valid_jumpdests(self) -> frozenset:
        dests = set()
        pc = 0
        code = self.code
        n = len(code)
        while pc < n:
            op = code[pc]
            if op == JUMPDEST:
                dests.add(pc)
                pc += 1
            elif PUSH1 <= op <= PUSH32:
                pc += op - PUSH1 + 2  # skip the immediate
            else:
                pc += 1
        return frozenset(dests)

    def __len__(self) -> int:
        return len(self.code)
