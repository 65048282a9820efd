"""Launch drivers of the port (``repro.launch`` counterpart): the serving
steps and the ``serve`` command."""
