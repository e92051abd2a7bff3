"""card_bytes_per_row: the fullest card's peak allocation over set-up and window per
database row that one card serves."""

from hvq_bench import readers


def read(rec):
    return readers.card_bytes_per_row(rec)
