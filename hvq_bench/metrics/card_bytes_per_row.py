"""card_bytes_per_row: the card's peak allocation over set-up and window per database row."""


def read(rec):
    return rec["memory_peak_bytes"] / rec["rows"] if rec["memory_peak_bytes"] else None
