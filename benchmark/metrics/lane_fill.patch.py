"""The micro-batcher's lane fill: lanes that carried a patch over lanes
computed, over the window's batches, in percent."""


def read(run):
    lanes = run.observed.get("lanes")
    if not lanes or not lanes["computed"]:
        return None
    return 100.0 * lanes["real"] / lanes["computed"]
