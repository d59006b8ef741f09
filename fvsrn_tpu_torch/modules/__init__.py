"""Scene-file registry (``registry.load_from_json``)."""
