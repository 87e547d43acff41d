"""Host runtime: the native queue bindings and the threaded pipeline (the
reference's tracking / mapping thread topology, SURVEY.md §1)."""
