"""Command-line tools of the port: the CLI (``cli``) and the on-device fuzz
(``device_fuzz``)."""
