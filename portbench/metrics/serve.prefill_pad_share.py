"""``serve.prefill_pad_share``: the share of the tokens the engine's
bucketed prefills ran that were padding: the delta of its counter
``serving_prefill_padded_tokens`` from the window's open to the start of the
traced stretch, over the prompt tokens of the prefills that ended in that
time plus that delta."""


def read(run):
    window = run.facts.get("window")
    if window is None:
        return None
    before, after = window
    padded = after["padded"] - before["padded"]
    total = padded + run.facts["prompt_tokens"]
    if total <= 0:
        return None
    return 100.0 * padded / total
