"""The query-serving front end."""
