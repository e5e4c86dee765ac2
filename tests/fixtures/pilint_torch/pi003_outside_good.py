"""A device scope outside the index's modules — PI003 negative.

The decode step writes its cache in place by design: it is an LM step,
not an index scope, and nothing reads its pre-step cache again.
"""


def decode_step(params, cache, tokens, pos):
    cache["k"][:, pos] = tokens * params["w"]
    cache["v"].index_copy_(1, pos, tokens)
    return cache
