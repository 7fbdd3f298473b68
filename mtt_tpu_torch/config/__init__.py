from .config import (DB_SCALES, TASK_META, Config, create_config, load_yaml,
                     parse_task_dictionary, task_table)

__all__ = ["Config", "DB_SCALES", "TASK_META", "create_config", "load_yaml",
           "parse_task_dictionary", "task_table"]
