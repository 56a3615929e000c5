"""rays_per_s: every ray trained in the window (steps times the batch)
over the whole window, on the host's clock; the window ends when the card
has finished its last step."""


def read(record):
    if record.get("kind") != "map" or "window_s" not in record:
        return None
    return record["rays"] / record["window_s"]
