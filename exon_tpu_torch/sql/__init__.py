"""SQL frontend of the port: lexer, parser, statement execution.

Counterpart of exon_tpu/sql/ (``__init__.py``:1-7): the lexer, AST and
parser are copies, and ``frontend.execute_sql`` binds statements to the
port's logical plans. ``ExonSession.sql`` is the entry point.
"""
