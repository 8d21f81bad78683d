"""nodes_per_s: trie nodes hashed (hash cells) or verified (verify
cells) over the whole window's time, host clock."""


def read(r):
    return r.calls * r.nodes_per_call / r.window_s
