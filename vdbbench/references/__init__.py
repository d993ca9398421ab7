"""Plain references, one module a semantics, found by the ``reference`` key
of a configuration's file. A reference imports torch and numpy only."""
