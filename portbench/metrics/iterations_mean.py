"""The entry's own iteration counts (with_info=True), mean over batch 0 in one untimed call after the window."""


def read(rec):
    return rec["iterations"]
