"""Host seconds of the trainer build after the graph: ``from_arrays`` with
the built graph (features to the device, the kernel tables, the model)
and ``load_params``, ended by a synchronise."""


def read(rec):
    return rec["spans"].get("model_build_s")
