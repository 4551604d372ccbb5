"""Host seconds of the graph build (``graph/storage.build_graph``, native)."""


def read(rec):
    return rec["spans"].get("graph_build_s")
