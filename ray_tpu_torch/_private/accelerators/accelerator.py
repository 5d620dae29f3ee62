"""Accelerator manager ABC.

reference parity: python/ray/_private/accelerators/accelerator.py:5 — the
8-method contract every accelerator family implements.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Optional


class AcceleratorManager(ABC):
    """Per-family detection + visibility plumbing."""

    @staticmethod
    @abstractmethod
    def get_resource_name() -> str:
        """e.g. 'TPU'."""

    @staticmethod
    @abstractmethod
    def get_visible_accelerator_ids_env_var() -> str:
        """env var controlling which accelerators a worker sees."""

    @staticmethod
    @abstractmethod
    def get_current_node_num_accelerators() -> int:
        """How many accelerator chips this node has."""

    @staticmethod
    @abstractmethod
    def get_current_node_accelerator_type() -> Optional[str]:
        """e.g. 'TPU-V5P'."""

    @staticmethod
    def get_current_node_additional_resources() -> Dict[str, float]:
        """Extra custom resources (e.g. TPU pod-slice head markers)."""
        return {}

    @staticmethod
    def validate_resource_request_quantity(quantity: float
                                           ) -> "tuple[bool, Optional[str]]":
        return (True, None)

    @staticmethod
    @abstractmethod
    def get_current_process_visible_accelerator_ids() -> Optional[List[str]]:
        ...

    @staticmethod
    @abstractmethod
    def set_current_process_visible_accelerator_ids(ids: List[str]) -> None:
        ...
