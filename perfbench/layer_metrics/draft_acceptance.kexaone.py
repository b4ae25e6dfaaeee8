"""Percent of the prompt-lookup drafts that the verify passes committed: the
program's counters ``decode.accepted`` over ``decode.drafted`` (K drafts a
pass for each row that commits a token there)."""

from perfbench.program_spans import counter


def read(trace):
    drafted, accepted = counter("decode.drafted"), counter("decode.accepted")
    if not drafted or accepted is None:
        return None
    return 100.0 * accepted / drafted
