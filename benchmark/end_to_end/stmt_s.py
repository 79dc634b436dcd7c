"""stmt_s: the window's seconds over the statements completed in it (a
step of the SQL loop is one round of its statements)."""


def read(window) -> float:
    return (window.end - window.start) / sum(u for _, _, u in window.ops)
