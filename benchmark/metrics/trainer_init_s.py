"""Host set-up: seconds in the program's ``Trainer`` constructor (partition,
layout, tile layouts and walks, the wires, the transport profile), by the
harness's clock around it; the slowest rank."""


def read(record):
    return max(r["trainer_init_s"] for r in record["ranks"])
