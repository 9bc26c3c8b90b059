"""The wall of every CLI scene the window ran (the one running when it
closed included), over their count."""


def read(record: dict):
    if not record.get("cli") or not record.get("scenes"):
        return None
    return record["window_wall_s"] / record["scenes"]
