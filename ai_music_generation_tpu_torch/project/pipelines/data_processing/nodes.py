"""Data-processing nodes (ref: pipelines/data_processing/nodes.py:1-3)."""


def process_data(data, drop_duplicates=False):
    """Identity placeholder node — same as the reference's only Kedro node,
    with one wired parameter demonstrating ``params:`` injection."""
    if drop_duplicates and hasattr(data, "drop_duplicates"):
        return data.drop_duplicates()
    return data
