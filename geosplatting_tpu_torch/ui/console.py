"""Console UI: status spinners, progress bars and a live training dashboard.

Counterpart of ``geosplatting_tpu/ui/console.py``: ``sparkline`` and
``line_plot`` (block-character charts, plain text), and ``ConsoleProxy``
with ``print``, ``status``, ``progress`` and ``screen`` (a live dashboard:
a loss line plot, a metric table and the run's progress bar) drawn with
``rich``. ``rich`` is imported where something is drawn, so the package
imports without it; drawing without it raises an ``ImportError`` that
names it.
"""
from __future__ import annotations

import contextlib
from typing import Iterable, Iterator

_SPARK = "▁▂▃▄▅▆▇█"


def _rich():
    """The ``rich`` package, or an ImportError that names it."""
    try:
        import rich
        import rich.console
        import rich.layout
        import rich.live
        import rich.panel
        import rich.progress
        import rich.table
        import rich.text
    except ImportError as err:
        raise ImportError("the console UI (the tasks' dashboard=True) draws with the "
                          "`rich` package, which is not installed") from err
    return rich


def sparkline(values: list[float], width: int = 60) -> str:
    if not values:
        return ""
    vals = values[-width:]
    lo, hi = min(vals), max(vals)
    rng = (hi - lo) or 1.0
    return "".join(_SPARK[int((v - lo) / rng * (len(_SPARK) - 1))] for v in vals)


def line_plot(values: list[float], width: int = 60, height: int = 8, label: str = "") -> str:
    """Multi-row block-character line chart of the last ``width`` values."""
    if not values:
        return ""
    vals = values[-width:]
    lo, hi = min(vals), max(vals)
    rng = (hi - lo) or 1.0
    rows = [[" "] * len(vals) for _ in range(height)]
    for x, v in enumerate(vals):
        y = (v - lo) / rng * (height - 1)
        r = height - 1 - int(y)
        frac = y - int(y)
        rows[r][x] = _SPARK[min(int(frac * len(_SPARK)), len(_SPARK) - 1)]
        for rr in range(r + 1, height):
            rows[rr][x] = _SPARK[-1]
    out = [f"{hi:9.4g} ┤" + "".join(rows[0])]
    out += ["          │" + "".join(r) for r in rows[1:-1]]
    out += [f"{lo:9.4g} ┤" + "".join(rows[-1])]
    if label:
        out.append("          " + label)
    return "\n".join(out)


class ConsoleProxy:
    def __init__(self) -> None:
        self._console = None

    @property
    def rich_console(self):
        if self._console is None:
            self._console = _rich().console.Console()
        return self._console

    def print(self, *args, **kwargs) -> None:
        self.rich_console.print(*args, **kwargs)

    @contextlib.contextmanager
    def status(self, desc: str = "Working"):
        with self.rich_console.status(desc):
            yield

    @contextlib.contextmanager
    def progress(self, desc: str = "Progress", transient: bool = False):
        """Yields ``track(iterable, total=None)``, an iterator that advances
        a progress bar."""
        p = _rich().progress
        prog = p.Progress(
            p.TextColumn("[bold blue]{task.description}"), p.BarColumn(),
            p.TextColumn("{task.completed}/{task.total}"), p.TimeElapsedColumn(),
            p.TimeRemainingColumn(), console=self.rich_console, transient=transient,
        )

        def track(iterable: Iterable, total: int | None = None) -> Iterator:
            items = list(iterable) if total is None else iterable
            n = total if total is not None else len(items)
            task = prog.add_task(desc, total=n)

            def gen():
                for item in items:
                    yield item
                    prog.advance(task)

            return gen()

        with prog:
            yield track

    @contextlib.contextmanager
    def screen(self, title: str = "Training", num_steps: int | None = None,
               plot_key: str = "loss", compact: bool = False):
        """Live dashboard: yields ``update(step, metrics)``, called each step.
        A ``plot_key`` line plot beside the metric table, the run's
        progress bar below; ``compact=True`` draws the table alone with a
        sparkline."""
        rich = _rich()
        Layout, Panel, Table, Text = (rich.layout.Layout, rich.panel.Panel, rich.table.Table,
                                      rich.text.Text)
        state = {"curve": [], "metrics": {}, "step": 0}

        def metric_table():
            table = Table(title=None, expand=True, show_edge=False)
            table.add_column("metric")
            table.add_column("value", justify="right")
            table.add_row("step", str(state["step"]))
            for k, v in state["metrics"].items():
                table.add_row(k, f"{v:.5g}" if isinstance(v, float) else str(v))
            return table

        def render():
            if compact:
                t = metric_table()
                if state["curve"]:
                    t.add_row(plot_key, sparkline(state["curve"]))
                return Panel(t, title=title)
            layout = Layout()
            plot = Text(line_plot(state["curve"], label=plot_key)
                        if state["curve"] else "(waiting for metrics)")
            top = Layout()
            top.split_row(Layout(Panel(plot, title=plot_key), ratio=3),
                          Layout(Panel(metric_table(), title="metrics"), ratio=2))
            rows = [top]
            if num_steps:
                frac = min(state["step"] / max(num_steps, 1), 1.0)
                done = int(frac * 50)
                bar = Text(f"step {state['step']}/{num_steps}  "
                           + "━" * done + "─" * (50 - done) + f"  {frac:5.1%}")
                rows.append(Layout(Panel(bar, title="progress"), size=3))
            layout.split_column(*rows)
            return Panel(layout, title=title, height=16 + (3 if num_steps else 0))

        with rich.live.Live(render(), console=self.rich_console, refresh_per_second=4) as live:

            def update(step: int, metrics: dict) -> None:
                state["step"] = step
                # one host read a metric (a card tensor syncs here)
                state["metrics"] = {k: float(v) if hasattr(v, "item") else v
                                    for k, v in metrics.items()}
                if plot_key in state["metrics"]:
                    state["curve"].append(state["metrics"][plot_key])
                live.update(render())

            yield update


console = ConsoleProxy()
