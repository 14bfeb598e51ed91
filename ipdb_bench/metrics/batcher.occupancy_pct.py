"""Tokens sampled over the slots the batcher's ticks offered: output
tokens / (sampling rounds x num_slots)."""


def read(r):
    rounds = r["spans"].get("engine.sample", [0.0, 0])[1]
    if not rounds:
        return None
    return 100.0 * r["gen"]["output_tokens"] / (rounds * r["num_slots"])
