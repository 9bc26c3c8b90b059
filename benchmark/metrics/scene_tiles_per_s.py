"""Real tiles of every scene the window finished, over the wall from the
window's start to the last scene's refined DSM in host memory."""


def read(record: dict):
    if "scene_tiles" not in record or not record["scenes"]:
        return None
    return record["scene_tiles"] * record["scenes"] / record["window_wall_s"]
