"""One runner a kind of cell: ``runners/<name>.py`` defines ``run(...)``,
which ``run.py`` calls for a configuration whose file names ``"runner":
"<name>"`` (``stream`` without the key); ``run.py``'s docstring gives the
contract."""
