"""The reference's trunks, one family a file.  ``model.build`` reads every
``*.py`` here whose name does not start with ``_``; each declares ``NAMES``,
the configuration ``backbone`` names it builds, and ``build(name) ->
model.Trunk``.  A new trunk family is a new file, and nothing else changes."""
