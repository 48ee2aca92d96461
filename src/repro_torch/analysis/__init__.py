"""Analysis of the port's steps. This slice holds the byte accounting
that the dry run records (:func:`.memory.memory_report`); the JAX
package's lint gates (host syncs, primitive budgets, donation) have no
counterpart yet."""

from .memory import memory_report

__all__ = ["memory_report"]
