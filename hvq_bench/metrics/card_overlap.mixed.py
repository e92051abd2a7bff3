"""card_overlap.mixed: each card's busy time in the profiled calls, summed
over the cards, over the union of their busy time: how many cards work at
once while any works, from 1 (one at a time) to the cell's cards."""


def read(rec):
    prof = rec["profile"]
    if not prof["device_events"] or prof["busy_s"] <= 0:
        return None
    return sum(prof["busy_s_by_card"]) / prof["busy_s"]
