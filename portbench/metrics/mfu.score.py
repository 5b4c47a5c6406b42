"""mfu.score: the forward calls' model operations over the traced window,
against the card's dense bf16 peak, in percent."""

from portbench import work


def read(run):
    flops = run["steps"] * work.sequence_score_flops(run["config"], run["batch"], run["seq_len"])
    return 100.0 * flops / run["trace"]["window_s"] / work.PEAK_FLOPS
