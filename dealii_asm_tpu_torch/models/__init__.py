"""JSON-config solver entry points."""
