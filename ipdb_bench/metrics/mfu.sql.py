"""Model FLOPs of the traced window's served tokens over the window at the
card's bf16 peak: 2·N a token fed through the weights (prompt tokens not
served from the radix cache, and every served token but the last) plus the
attention's products over each token's causal context."""
from ipdb_bench.harness import costs
from ipdb_bench.reference import judge


def read(r):
    reqs = r["requests"]
    if not reqs or r["window_s"] <= 0 or "trace" not in r:
        return None
    m = r["model"]
    hit = r["gen"]["radix_hit_tokens"] / len(reqs)
    heads = m.get("num_heads", 0) if m["family"] != "ssm" else 0
    tokens, flops = 0.0, 0.0
    for prompt, text, error, *_ in reqs:
        p = len(prompt.encode("utf-8")) + 1
        o = len(judge.served_tokens(text, error))
        fed = p + max(o - 1, 0)
        tokens += fed - hit
        flops += costs.attention_flops(m["num_layers"], heads,
                                       m.get("head_dim", 0), int(hit), fed)
    flops += costs.serve_flops(r["n_params"], tokens)
    return 100.0 * flops / (r["window_s"] * costs.PEAK_FLOPS["bf16"])
