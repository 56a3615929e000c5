"""The cell cut to a size a CPU test can hold: 4 keyframes of 24 x 32, 64
rays a step, the mapper's widths unchanged."""

TRAFFIC = dict(keyframes=4, warm_to_step=4, trace_steps=2, bytes_steps=1)


def configure(cell):
    cell.config.update(num_keyframes=4, frame_height=24, frame_width=32,
                       rays_per_batch=64)
    cell.workload["traffic"].update(TRAFFIC)
