"""The text of :mod:`richsem_tpu_torch.utils.visualizer`: OpenCV's
``putText(..., FONT_HERSHEY_SIMPLEX, 0.5, white, 1, LINE_AA)`` glyphs as data.

For each ASCII character 32-126 the table holds its antialiased alpha mask
(the pixels OpenCV draws in white on black), the offset of the mask's top
left corner from the pen (the text's baseline origin) and the pen's advance,
all in pixels; ``TEXT_HEIGHT`` is ``getTextSize``'s height at this scale.
OpenCV places each glyph at an integer pen position and blends its alpha
linearly, so one mask serves every background. ``tests/test_torch_visualizer.py``
rebuilds the table with OpenCV and checks it against this one; run it as a
script to write this file's ``_DATA`` anew.
"""

from __future__ import annotations

import base64
import functools
import zlib
from typing import Dict, Tuple

import numpy as np

TEXT_HEIGHT = 14
FIRST, LAST = 32, 126  # the table's characters; any other is drawn as "?"


def pack(table: Dict[str, Tuple[np.ndarray, int, int, int]]) -> str:
    """{char: (alpha [h, w] uint8, dx, dy, advance)} -> the base64 text of
    ``_DATA``: an int16 header [h, w, dx, dy, advance] a character, then the
    masks' bytes, zlib-compressed."""
    head, body = [], []
    for code in range(FIRST, LAST + 1):
        alpha, dx, dy, adv = table[chr(code)]
        head.append((*alpha.shape, dx, dy, adv))
        body.append(np.ascontiguousarray(alpha, np.uint8).tobytes())
    raw = np.asarray(head, "<i2").tobytes() + b"".join(body)
    return base64.b64encode(zlib.compress(raw, 9)).decode("ascii")


def unpack(data: str) -> Dict[str, Tuple[np.ndarray, int, int, int]]:
    raw = zlib.decompress(base64.b64decode(data))
    n = LAST - FIRST + 1
    head = np.frombuffer(raw[:n * 10], "<i2").reshape(n, 5)
    pos, table = n * 10, {}
    for i, (h, w, dx, dy, adv) in enumerate(head.tolist()):
        alpha = np.frombuffer(raw[pos:pos + h * w], np.uint8).reshape(h, w)
        pos += h * w
        table[chr(FIRST + i)] = (alpha, dx, dy, adv)
    return table


@functools.lru_cache(maxsize=1)
def table() -> Dict[str, Tuple[np.ndarray, int, int, int]]:
    return unpack(_DATA)


def glyph(c: str) -> Tuple[np.ndarray, int, int, int]:
    """(alpha, dx, dy, advance) of ``c``; ``?``'s for a character outside the table."""
    t = table()
    return t.get(c, t["?"])


_DATA = (
    "eNqlOQdYlEfTc8cdB0dTBKVYImpULGiiaIKxxG5EVFCjRtQYo2is0SBW7CUqscXYQKPGKEqsp4m9kYs0hSBYkEOkifR2"
    "ff+Z3cPw6Zc8+Z9vD96Z23fL9J3ZAxDNCuxAChKoYlYgAzn2VDE5KPEDUM2U4Ai2iFUyW7DHkfTWDjElx5Q4w4pjVuCE"
    "c6VQgeP+wuRgzd9a4xq0Sg32iRlmnGGFbyWgZwocTRRQnyMo+G4K3MOWz7XFXW04fYTV9tV9+3bff5v732Yo+L463NeW"
    "U6VjMrDlFNQgBXLE6K0N9hGl1Efr0Vyiz55LiKRSKw1aWcKxWgnZ1umry4fAbOpIsu44oQ/Z38igdi7tK+H6eHvfv9az"
    "/Zu+N6Vhw/tqKfiLenuLzuv2Kd+a64R6laDeZHU0SH3A+6xQlhJuB1JuQwzXs+IzyNZsuUy1nIJa3v6zD97qs+Yryy1v"
    "tVwaf0mo1iYdcQ/GCLPjuqziGqy1dlpHgnMdELPhmG2dPewsfTYWnRNmw/nQcpoVvI/Ws7b4jC3fg1axqTPDnmP2dfrq"
    "rmdjWcXpNUfOnL5y7lG1fVZ8ZT3OmOz7dHXdT4jf/s+rD7ge/HDFXHc26na0leGj6B2wu9Gk4Tg18DuwiW1ITr5jH3Qw"
    "4GrfxeSkxdytiZkF08OrDoffehg+DEBp9oYfv6NhPkYFqGcAvK/JN2k0hpeabg7+R/8YFsyChzkCRG6H7tVSGtf/XfAY"
    "bgkf5e9zaP8l29kG4cjyvEv5bCFA0lUAyT5zMzvjcux2mOIGV8rmNRBj95Trz40h5sBu7GnTHw3FUj3M8wa+9EbEuXqt"
    "Y/6joPaBZw2+4HWukhnjBvDBrJ8YKVnUiIBLyGiSn9t8K6km8soxANmNKPjwCTTS2sD6FCUMSAIlcxxShnTZ5Q2cf7Pp"
    "q7E0rc/hbR1+323tK+drRSR0zY/La02kl7SIWA+bNwG0KBkBJ2fC7ONgk7gVYPleiAqFZbdwgvuVV7+6WCInVw84hmyf"
    "whHrhKyovLOE9WZtoS/zRKwT84HJOjJ5yZnUNdrpfNo0ZvYH8O8F3+iWpqnrQc4iW91yaJQSN9zs3dA8EvlKMv0M8Edy"
    "d8/xuYb7LtDwopYVbmkSF0+7uPE1UOOob9Q26pok+g7AOv0pGG4MlMGRo9iTi2qUmAYhfewjAE/WBeewDwAU7GMKb4H4"
    "UK/Bx6qHKEKP7FjctvXG5a602Czzb9jXKZdMYvpzfHRgLdFKaB2JCSmHis/IakehvFl/gIasK8BAPdr5oZvgE63vByP2"
    "cD2NyLcG+S9fa+YsczmRyWJXgW9R7DV7GHKyxTWu8TmNLHKs7FMXkXt6elaN8vR0GM9EOyKxt7evGmJvL397MLWv3el5"
    "dL3SHOJTWU/mCq64goekmuZ2btyiRQsv6W9bqq/wseO301P6+GsCA6udCZw9QM93jNyQN/xOT5vCCQSCX5KXwx/r6dnF"
    "2IxA1Bl6NqjmFrngkYSAl5eFFPeZO0M7Iuycb77NGIrpeo437GevHOzM+8Dm2XQ2oB0bDxO+92AzurBhoG7vyOa9x4Z3"
    "uQFObG5jtjByNHRlEyTFiU/lsJx1htWM9VxdcguFcogx7RlXbvwewnBtZg3ldMez0+SSRYlPCM7aYxN7WhDzr2A7f/80"
    "tb9/gx+FrEejwczcOYe80D2jWFVUgxa0t6gZWKfcB7i4AbvX63kIAOmdZOGL282cDmmkmZu39KB5hgXO5gP2s4v+2OwV"
    "erGFHwQtoTYNYGdiYmIySxPrHCxpz5Fvtb04XGgaJfg0scLz7xLWtNWY+CIHQXx/NqR5HNozjGF95U8fD2v3xZMca/A6"
    "a2BVlxrTAHljK4tSJJNChcSmM8Yl2KbqAkesE6LHcGTjC2eO9DH2B0LqP48AjoSzhLt3H7EH3/dcge0U2zReWJFYByOs"
    "sR6AUxixEwTQiyUjQztoqq14P7fEQsOGnI0XDqGPwUF2OizajFbYrB1+W8ZaAxdnRxbkaJiPyFjsOV86sc24V+jtdodL"
    "WHm0E2fiNTtui5qJyHs9Q8hiiaE7h90Nyzl0zGB6zV4MtZtZ1Ig5hSkKRdlP2P0hm9CUfUmaqV4nebmbdI/qXmla1mno"
    "4zRkY8lTVnbOg6/gQnt9yrW00OpgKrYis5K/uX+Zg55ovNROZnDqm3LS0TYq6hGwffU9/zrF3FZM+pUDHwpH1Jp/tXOR"
    "L8KPSx8dijXNBbh0ByPophIZpNLEMWYXWFn+RZuAjOso3Dw0GTMyGJc1orHfzWLPNoxOnobGaZ1qEdmDrGHu3W9UeELT"
    "kwamjSXBgqyx0HmTObsWtCJ7KS24mFM9GmTPY+1BoSqp15aN52bUrzkXSgDrKYl/7AUeibkKaJ1ifmHi760/CDUdE/Z+"
    "WcOZgwXGjzj01K4g8Oqaartg6/SWittwpRC2XYDXLTwa0n+Q4THGYxTIl/Uk+4sr7giS2dUXPaHR5YppGEK+YjzeKPca"
    "N/KI80luSmceZk7o/fjETzs/Kqc2tXMPag0sy7ftQq1elp7a9MNNqO9GCa1lFao9RUbaITGfIpVn/h2A4QWJbZ0OGlZb"
    "w9P0bti5WOgUBm+ImICp2iHzH78abssGs5lkhp+MPYMS7Mz8+dl2OZMfYtGlnYX9C/Uffi4WGD9DwG/CBIx7IGDQ+Yzc"
    "O9vJpiTHns309R79QyWeDNPTPECplEpn5DhC0uewpKAyabUkb5Czwdkjv22rFxvgp7DWJTDlJMb0DbB147ulMOY4QMw2"
    "2B1uX9O6fkkf/6KMkZrBcOEADL+b8dm620uRXp0333EQnW5fGePCAkIu5VF4gK4Lj12J+tJORIKvZkkEZX6MiSgD+5Mf"
    "HOSIXfm8uZWOhE3Su7rqviDsZgzAqbuItKQjeyjDTGItiz52LJptBKvs+Ehs8bkoMV9+QDD//Uli0fiDAeg7YYHIuqr4"
    "8uXb2oreoLpJB3XmXYHA0XxQ3ba1dR5VFQUqHhjz64Mqztvb5+uiny1jVuucBLLe4KRK9PX1W1HyC8SQQzzeTRFGOWhl"
    "xJdklXZ32OM7uvwPAfaY0MKcc5/LQHOdZn7G2ruyucL4oAmbajGcxq8xGy1P/dyWusGdXPL7w8wN49rZkT1Wm0kw4xIM"
    "rHi1iGd2POwRa1+8j3aqqkhMLGdZXpxaxeCMpxayV7DmAunEAgXSmAULpCmbIJCPWE+BrDQ5qJIHDBi3zbSbs1Z0Y5mU"
    "b4Hyc1SVYUBNjG+iEhEE3oK6AmxXQHU/CFvPt9/HD8DW3z5GHD19xbqh1qpKCmrJ9VRXLePehC9PY1sNqpz92BbC342L"
    "ee3qigErvvuS0gnlFfbkSmkh2uEuEwYKl3uvlPDsGg1pt9W9AZtXmymwEDzicJOuboQFrdrGxttoI+iVL+sLN/Oodlqq"
    "t4ORhtNBXZYYt+DXUYkGc/pSMV9Zn6siiHtnaCshSzc28Z8QkxabDpH0idhm/+PgGC7BBsYxAWNU6jc/MTdgKpfkYnc4"
    "9wDbEzZQkNXt3yFNR9K5Eci6BiCveCjWWNfPfezfdWf1LjwKb5hZTgQ/V5Q8agbQuekZ2pGE7pUZ74yw7QvMm1VXOxXc"
    "QYdVZRbfoCpLxYrrCeXpY+RcSSN0p+RcWcO0J+VcaUNqTsi40gaWRQSMsijzzv8IH1J+M0QqjMzoMmyc6J/eU2VsJ3KV"
    "XSoWQ/HnHmIaE0aLkdUFu1QXTl4Gq9TNqYi1M30cXO5KGBz549ka4FgrQ0l9gcFolJ3AqKXuOhUjsMQtgot30KaNFIVG"
    "sUYqlmItkLSaFQK5EKprLxDZPbUVR6CDbr5AYHnVIoHI71cIBN4zsEYxp3gMMqJV23yyasMIyjbsr+nVN6vvY+a+q6IH"
    "nmT55wHSfuIhqlzmZOZpQCDr6M7PVOjH/NzYNJ5qs+7yqj2ELWYecO0VVUwpzzC6mC4FDf6ZheLXCWkmc8ZCwZZ9/dpA"
    "8/UA0nB5bOxD9txHiNxLc9si+3V6hUBUz0GVHhT0RbRxFaj0BQVZl3BXldria28jaMC17Q3Wkhq+Zu3Ma9bK/i1rzWtZ"
    "K5PUsrbUwppGpMfE2sZXTsTa9HeIpLLY2Ccs2UWEzncrQi0x9Kc0gUifnQPVs9DQzX/WDEM53LuXX4mHEL36wDxOIHAk"
    "204gjSvXgHDcRVXoCm1m7VpKRc3o6oJLuSY0hWd3JCDZYW6n0K0j75riCecrFohyVrmrTH9hnA1Hx5wyJoh8BXxNYb0K"
    "O1FSWf6tIufp6PYjT5n8wPNcKTOkDhDVCCUs/ZaI5rEqI6OQZWZk+PJ0u57FEf43ZJKBvHvcYMKdwjwSTvBkkg36fyGn"
    "U3gaxdovYZQOHq+w8i65P6PPXu1OgPfjtLURx5pXpt1E5eK0qHEAFc4AIUZ3RclmnhFgEDnwHMc2Nk0lK8AQP1+HHmKV"
    "h6Hr3nkasr1A1pInj/ABG7CkiifpksyoP08IdtbXsBECa6fLI4G3XKAQ320XNv+A9RD4x+x9pQHJcMFUb4FOAcl4Fj/E"
    "tOpYAobLZGjD0NYe7cV6z2D7TULKHEfTNMrwu91dvPJqLyrI7YwrTK199Kv0tPafxcj9k+JEWvgQC8eCh+0jfKrem1x9"
    "IuZ5i3jmM3AGNC87TClq9SYUPPsU5HHJtMKp4iartD68Nsi7bwgVNH7G/hRFifSa0djDUrR9kphJBUsn3Wass44iU6mJ"
    "6BFfokCW0UUMQHSJ8qOZPA3zWNyAGzEu/1QBhzAdRGfCPMu9fAsoHqn4evr2i3W8+LN+FFe1wZKvshx7i/e+3FHrxwXb"
    "3sayNvHTbLE4q5w70VH1oITxHBZalp/nVFjH5YpqboupP4dDzN9y6PEynl/sSK9WcApgKZvM4XsGHvH9XYItNxRjN0ZG"
    "9i6M3dercBbAv/4v0kwcOXlyq1mr+KL9dPw6RJK2mH+dncVF61Qh7tl++I2DDmZByS2es8GYEp7XynNFMrdSZJ+ehg85"
    "jD7CQUOf0ZGR80btS8E8NuJf/y/TlN19b/LkvjAv2h2WpO9/2ChACb4t7CIPWtq7ddArTxuD3ck4FCd6Qv2daRnHvQAu"
    "pAcM+z1dBkM8sZ5haGitw08/Yd3g5xfbg4JZtx5GHDOVdevNRsl8X7BukpVVpsLlpk50AUSsrx0qdKhZ/waM2JT6AFNE"
    "jeHM+I2mVaBJxNG7SqWarTw+N9FsBMrUW2iu8gRKrmGL3hlaegTSd6jNpks82NXj1iNdfDvrIkpqZ/nmT3/TdVZUo9k4"
    "xC3oyi/IqEL4QFTTBozg0ohP4WLm8CbrWCA4nq1mpaHiikFWa2nBloPrR/VraP3tw6QlR9VwoHp58HWDur4RFavMVndn"
    "VNEdV/fkkeWI2pN9TlpXw/XsPi22MjU0vWs2Xjpy4zWdMO9W+g94VKwpDu57Lq2+vAI93bZkajf23fz587P29GAndmGb"
    "KMuhWzlbK1in6Wgz1TASnJc/M73imb/U3VL1OGEaPzyLHQdJ0SlvJ0zz0Nk2JbE09ZT+i9m2kE5YIFA69ndPN+7kis0P"
    "k5bN3g37q1dMuKaNdzQgX3Yv4rtwvo7Fd+PF0I/xLmZMa62exMO5l6N8o1g8uJ6pLD1yMl4a6GolhYsnZQWnFdCpbA70"
    "z9PmGw9jRFV06IEMrx1Rq+c34I51yUnhqHfdlc8P6deAhoqVsxrQ7KWKjznwcZOZ85swnexmnMFRcn6m5DIXx4nxkB3+"
    "5t9T1OgeDBcHhWfB5mUAV0/8/b96X6sw46SQW4ska0Vaqwl/A1itu+WoCXdSFfYCzY+pqS2wk92n0KjJMQbzIavoCMGR"
    "oaZZkI77z9QHrh2iWf3mJ33JiWlHMi91bBvz7Lg7ZJs2jv8zNztsYlYCZJ+lqhNPsOHMM3stGqQZbaMF65dNRJgnk94G"
    "/h1ODEP1ONJqrxMTN6UkLJVAds2lyUfQTrM1aDCXUiGboutckyybZDiVKd6ET+kGJFgnB8nX1zOOoj1vLt809nJJB+sq"
    "lKJt+Zb3WG+KQ7HdLTbhwH0p5wCc1wQ0XW8aAg6/VLJnU/h9DcXgY5O2PkxehaWrlnx7I2iSZZSNSTXfcd9uptnAfbul"
    "5iL5tsFaw0KbDS39GeV722T61ZVihJN9nVhxYUZtkheRdj989i44qA0PvqZV16PfJNAXffklwM9qP0Y3aFFqkdslquFm"
    "Tl+vDeiL78SajarTauGLkRbfroXLfzwxaf2NCdk18ev9sulszaZzg8vmrwcXEXidyExaKpdmqXoHvljrRhfDzg3hnC56"
    "Mua5skH7n+sm8Ru9nwp6Vo62clcnwIIivSkeiweJO93ReEbShU931rb2uelP9kD9cf9NbGVIs7r9lqcP58dWG+2HUh37"
    "yLz4V7rv//x4zQK6isz+T1BNhvBtdipVFPHZOyunvruUZSvP6cy/73yCnk0WG3yGAsjiHZ1ZH4o9C+Ee5ggTdK4wpdoJ"
    "rh/HUWXTW5opRHx/b90TCa/8y0SScL0Uj7Vh9LPI+tXIzvmhPqwD2FaWKeA9RDLDICCvcAgsw1Jg212I2r1/P6hR2X2N"
    "bq/6D37pYcJYLC+JKpJbl0QVU7D9ie4kDpv5yTbCOAgPa2MAQO/brQEaXR0qu5WitLqaaAOeBYfWlLag0stk5vGkt9FI"
    "Yd0t7/jhAk+wuv7QQZl8Vz6zFI+lVsULJ5yjE2fegY4UEJVFS+AGGtjUGlcINLWEB5Goo+ebezJKg8OKzvHSwaWGjRQm"
    "phHndLk4AOZU1hc3Y6vp6a2mtg0ahISEbGc8LXFMT6CcT/JLUXNeMph4WjvQyM2kWdGDzj4+3iDyCgMe7pJxEZg/RtT8"
    "4gB2lSH8t5jW/Bcmys+nVuHeTZ//wlMTupS0vXmfX8fxy1o/RvfgbRj9HiHL30rp7eemXDoAvUZaf9o0b8I/fXLGu8rH"
    "hLWkC+lHr4hSed4ynlNE03Mvv89Y84JfBZv5jYSqAtnyN1G2suYR9xJeh5yhAqpJ5VdIoTEJRfN+T7pJcgka6AhNGj0p"
    "1Roy9X36SK17feEH/wfFZILN"
)
