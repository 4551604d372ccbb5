"""Command-line tools of the torch port."""
