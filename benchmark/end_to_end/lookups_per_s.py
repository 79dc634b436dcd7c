"""lookups_per_s: the (record, field) lookups of every batch completed in
the window, over the window's seconds."""


def read(window) -> float:
    return sum(u for _, _, u in window.ops) / (window.end - window.start)
