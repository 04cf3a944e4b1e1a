"""Arithmetic-coded JPEG files (SOF9, SOF10) carried as bytes.

Nothing here can write such a file: PIL decodes them but cannot encode
them, and the port's codec encodes baseline only. They were written once
with libjpeg-turbo 2.1.5's encoder, from a C program linked with
``-ljpeg`` that does, for an RGB or gray image::

    jpeg_set_defaults(&c);
    jpeg_set_quality(&c, quality, TRUE);
    c.arith_code = TRUE;                 /* SOF9, or SOF10 with: */
    if (progressive) jpeg_simple_progression(&c);
    c.comp_info[0].h_samp_factor = c.comp_info[0].v_samp_factor = 2;
    c.restart_in_rows = rows;  c.restart_interval = mcus;
    for (i = 0; i < NUM_ARITH_TBLS; ++i) {   /* the DAC marker's values */
      c.arith_dc_L[i] = L;  c.arith_dc_U[i] = U;  c.arith_ac_K[i] = K;
    }

The images are 67 x 45 (odd sides, a ragged MCU edge): the colour one is
``_image(np.random.RandomState(14), 45, 67, "smooth")`` of
``tests/test_torch_native_io.py`` and the gray one channel 1 of the next
draw of that generator. libjpeg's encoder writes a DAC marker into every
arithmetic file, with the defaults (L = 0, U = 1, Kx = 5) where nothing
else was set. ``PIXEL_SHA256`` holds the sha256 of each file's pixels as
PIL 12.1.0 (libjpeg-turbo 2.1.5) decodes them, ``convert("RGB")``, for a
machine whose PIL cannot read arithmetic coding. This module imports
nothing but the standard library.
"""

import base64

SOURCES = {
    "sof9_420": (
        # sequential, YCbCr 4:2:0, quality 90
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoM"
        "DAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsN"
        "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/yQAR"
        "CAAtAEMDASIAAhEBAxEB/8wACgAQEAUBEBEF/9oADAMBAAIRAxEAPwD/AOcfTzeWjFOnlATc"
        "IISllJh8gqnEBzbEC+Hvf6OruwtuIpiwIfdSzld804vFcGLv/wCC7wljigLWs+oeLZfnMGJD"
        "b+fA4jNdAvTsgz82eYvu+MW6r0a8EimGMfhw9pD4cwJA91GOpBeYQg5xn4b+RaqsBkKiucam"
        "RVkXSjbg+hAaK8eZaenJy+W4+CuxC5MWOWndJR7B9apMesxdcTJvnYu52yjez8wIGiS6Ol4K"
        "cC3AnXnlkOs3Nc3bKGRJK7bLL/LEsuq9DYnCWOpBBd2p1rlM5bzm5UXIVgsXdmrl8AgCvL7J"
        "/M70MxIRKcgX8Rzlll6ZSfbomtEe+vBnPyHmmvDIKZKLa1WWVfApvpHyFFiQLAZP0jQn9FjE"
        "7oR5jLZgKB3xlQRmU/7m88CyuEcOkUUlQbslipBZDA4K84iyENgwfOroeyGV9a+4BXvvvuqA"
        "ZhgXYEd2Ttj2GTZ5s3bhI7Q4aKj8PM2+LAkKRiC2B3YVliAwMkLmnp+GX5X7TQpN+ye7xY+0"
        "zU2TyeOCTdU7BPo0MAkSKnOigMdmEk5wNFXe38oSUX2LncLBmCjoqhdH1Wd/g/rJ9piqtscK"
        "dadvuXH0Xome31Z9nzJtKHfkNBzYNFZqd2ujHA40UvFhNSzK/lz3W07buyHfXWv4IYfBie1g"
        "CYnz8q8JNKIceTbuAUYTROL9wVfyNmGvTN4DCw0s0DOXcRP1alXJldmwXgWcdja7xYN27TSf"
        "Y1DkBvfS2NY5rHJEYaGxGCgfuFIEseg7f1c7AesSCPtfKdiU8SmV/LmpSbmo2Tp2hDDioxEl"
        "jzSxlmatc6z2MF7NUo19h3zSYm1A2Fx7MBSBKPH/AEJR8YeGyirg8+JUSc1u1UxB8htM8v3L"
        "l2d5uQXxvNLAYj0uqdO1eyWQNE5Foz6WgVF8WEbufMDhusko+WuosIeUsUpKk03RxJZQmjYx"
        "dFxEZo4up6V5boqT8AWUywfcA1w5VeQJV/Ldt0GaMvxMpwd3pVOVIoUYUGW1JWuI+A3Fypac"
        "+m9b74MRbsg9vcdC3qmDi91CJsq/qI7ed3nblxrG0kyekxgfd1jPAORzW3GXtpBmAPQSklXT"
        "64+aC6LWaZELH1+h0OWg2r3tnS6EMaR+oR4Oj2gXgEOWsMdurn1MNufX2pW0RjOlaCncVZkX"
        "i/00GDYrm9XafNfkvm0yU9ivDshHVDtWVhYZA0AZlUTUKQBI4BUBqJyW0MQ9R8Gvu9oLPL7w"
        "heBk+jFr3L60hRKtmDXwIrlwB+jGcVWVplZR+nIwL9SV7eZ5In1t3vEqX/8ALkDozlxSzpLI"
        "exIkn1PrfwroQzMMS94Z3skUHu9i9u0ZOeS2U+Pe9CgZZhgbRl97mHOCIu/TmUaJn6RcsfNb"
        "1C8VCMU+O8Hyqxln2YxhmGxElanmz2YaPilkiy3663IQAOqoBzoSAdOanV6iv7T53+CciFYU"
        "yeg13rTv8dnbQVPgMWSrkESIPT+ycamjPRUdIz4HRgD4mnhC+EaAlh3MwHwoSrqKLTs6hxrr"
        "u7zjtyiUDv3zAH/GPIzK8Kcf/wAygsAKCPKDM7y7Kll2JFtrxW0Y4deVp1jx+3vEEFaBLxVZ"
        "TFDfQz0d/AznYo48mzUU4Stfvzx+8JWAyN3VIcYXwWY00Zipw3y2Hx9RdgVESlhUwiGyR7dU"
        "YZEblN1ycRac7dXlIOuAaMtDnDnbbvRa7vlR5kPhtFMb6ZDL6DqSuMz5myQrJTmstueA6AhU"
        "pIAQ4cTGdQkzaja0V/n/ACVRg3H7/rwd7sc/BY/3dQVjEKr3yUpLZyytOWWBZEXbrvBJ7U9Z"
        "8xWNaJGO3Ex/ItzO6ULqFOtP7n44QnDVCLLwXLKGs1JpBjExxcVYgu5XgTDCTNX2zs2ud3wV"
        "4v8A6njIcANlxANx2/7qLLFq2xUrjVmTNEm9d1qJBSaD6Jlp7b3KesESzjPWZyPVhEUOq9G6"
        "LTiI2hTgQsL3no/Vt6z/AD9+apQhUfeKpMgOlOaPA53H2tM30VCvtNjMunQjWk4wVeOE0+M9"
        "IJ54aO0LM3dFdeNes27VMlAgeM+BeHU4hQBt4vs939YfGS8PUGcWXpAZP5vD2HUi0wBusRZo"
        "tYfAYPXwq8IRJF6T3kTDFIAsfF72EdT3GaIOD1kdcoLgTb5fVoSXJA/7F8ghE3iXbz3gixxI"
        "SkpDqqP+jTXX4OQo4j0lPNOQ4XQQs97SQZpFlbBVE0tPXJo7pNt87pv6imzoqgyg8wv4SnQu"
        "GzRM5iTpVHNI9Rdp2jKJqrqcnaVDg+KDbFBryQ6Ka6roOYfuv5K+0nsgk8IBRA7L67nnH1/N"
        "0qchyuoY2VA/eiRTFjRbgT+dsZQaa/bc5WJJotQc1Amgqj100axGOxYzENsYPHuJd3h3+gc1"
        "N9Qd8feSB+/H3+gZnT9HknTPjq5wgsD/2Q=="),
    "sof9_gray": (
        # sequential, grayscale, quality 90
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoM"
        "DAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/yQALCAAtAEMBAREA/8wABgAQ"
        "EAX/2gAIAQEAAD8A/wDoNhKix6NaR67zeQYbXfGDrL0qahWkM7288I9LfUezVhqZ/pL9wpTP"
        "J3/90jW/j+in/T4mG5S6MI7Ba5/B2F4xNdqs+a9NROW5K596BGXZVwcmHbiqP0MHiFeWHtN2"
        "QxxpjCz5wRWkcrXGD4D4fmlJrg69tNYFfTYeOwXk8VFFq8UW/wDHp5tR9tAE4OMKi6LnpiMy"
        "sCZKvfDlh8S1wrVjrZN1lGcimpjxPnVwRiAdNW+WEp6I77ToNyRrQPZFSAbaqjcNi/6ZdwCI"
        "EBUKvZmRmMnC/TwMgP5HVU0kPhGBNu0wdrNmfLCgVUXaANoBVum1d2KhMrs5i+pWaq1raU7o"
        "ob1CBy+WDXWilxR6dT3ExqEgmfXpCLR9LsNUsSfZc6/emFPjqRKH/NAdXBi8xtwNELy52+uM"
        "3ZEhDT2LVp290jEXN4JYaWKhy+5WjCeJwCcmVQCs3aWC1fib6Sw5hSEMZDfedsZrChvOdCLo"
        "oXf9HRAmJSR8vjqRKwc3AifTAAJAJnfLToDNrPKeVx2fZNMXa5P8ke0GvPcuMx8+RyqW/wAG"
        "1tJ/+hw1Yu0LPvwRVkS61raK4cruXEUPBl+PtdvewiH7y5MbZh3NxQx7B+zcKzwnjAe7RSm1"
        "1EZBrpfVjrKBC/WCXsx7K6+bqO8++vEvYhiag7QnH9cf8ZGcxM+VS/3zpLXSFZNDWDqDD+mD"
        "4jwmxJ99J9Esl+Q8jn6BnZj1QgKEHy/qtq/Cs9cK3R4+GqsxmVLMtTsp1sazqK3BcHUUk7HZ"
        "PRo7EkvsAyyGEEWz5PaDJFGh4Nys7dM7i3WjOXi7/Slpj94LMNUaY91EjH5lxix0a3mmg0in"
        "KLO9CmZR25xL7u7cWy2v/pruNWBLfAUZRpaEJV1apWJUdzcC+6+eA2EjsMBUWJN7j80t6aES"
        "Zu7GzLpA1MVFHoQEb0Byqz19mud74b8uacDXKLfRmvUMdqjCAxkqImYbuUcuqlBY7dFrINWK"
        "gltO5UkQVMlkJb61f7o/Vtrr4n1SP9ht+gifovkoU4HLDM9El7LnC/QGsfhCMVCbbi4wAwIM"
        "iHsu2o5hFKSt7KlBiaQI1RiIme9dIhGY7STi4ALvJ2VX+mxtKrD5qi0mFrYln+q9z44WZ7e5"
        "w9zqmNyr2ERkoAZZb/LqGnMiYLUxSwz+SZkUp5NRyEkuUXvqT1Xs1MJBlb9XgEhqK7XvjrYd"
        "NQD7+utJCQ1j49W3FBDl8YEdtOu0pBwVVEsPgCnyRr8y+6b/AD0WNdIIt3Bc567rJWMoeEux"
        "NzpDXChOqsUDbwrNHnF96cx4Gfj3KBiDewvOx5BSYQ+GnZQlAOlO8Qii01N4TkPuNeuu2xUq"
        "K5IVGYp9pU+cXvBLLmd13TbCuI0FpH3DQ/gt6UaUfcivzUnLNqWKVhFj5FQnWJ1ZTo2BLfnM"
        "L4PbHlZPPP6wG6hiwWgrRGHT1/aTx+MCZdeFjMcSIByu43axnNgd1Lw0mJtlwoEwb8u6Yztm"
        "WT1/8jU+m0XTtRT2LTuygIawZjSnRr6okEe9ISMFjOcQ0zNUUDT5Ak7MbEJJCAoz9SzhPG+m"
        "3rZU4gWmbY9BzVU/ELstaUn95n+0bzTi3ryS9HzPgzmVm37Nptoype/8d5SFlkBa2/RAKktk"
        "84VximiXmelofTNCRJETcWtrFS16ltz3UTaCCPYcOe5/HHhITDsMaYguwP/Z"),
    "sof10_420": (
        # progressive (jpeg_simple_progression), YCbCr 4:2:0, quality 90
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoM"
        "DAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsN"
        "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/ygAR"
        "CAAtAEMDASIAAhEBAxEB/8wABgAQARD/2gAMAwEAAhADEAAAAf8AziK86pvzamgafwYNFgWx"
        "qrumY7HELyhha3+Jhmh5T7wyp4P3oueYMoC4XNh7v9g6d5uYO/D8cYRK0bMiVXq0IjEU3PaU"
        "vd0zl/DsrQIGW94woPE8ayp11+aDXzgfHIqA/8wABBAF/9oACAEBAAEFAhRBdJoixuNSi2IH"
        "JdoYMAf0dVd6QWOT0tQEJdZtsQ5NdF6LqyEop6yByTuLsQWzdqkIL3N39WF1qHmSG3bT40Zb"
        "0feFrY11/Rbl7B7I2/XsZCwJXMrJdGsFNx+szLUqgdEf81s3Es4Rf8Acy4tP4YNiMqGMgVMM"
        "p+mlO5kV/wCipLibjnG/iqGDC9+aa8DwXDG27Dlh8eG6/Mb/zAAEEQX/2gAIAQMBAT8BFWup"
        "PGoiCbPISulMnuEysbX5Q+OM56Kx18/9crgr12awUEYkQFMEplyHL6CEEPt41zSw01RaSLsb"
        "kZIcu44M/ODD7QTnYeIF1P8Ai6lpgP/MAAQRBf/aAAgBAgEBPwEV9/jrHza2RGpy2kqARWIz"
        "VbyENeWajUsAvvprkaYlKSJAoYlTDfG1ZrysCGmwwpNegwj4lx+JFfOeQJ2tDfRJgLkhJv7/"
        "ABGwvGnPfaHiU/JYfa0yRQqUFpC7uPhrszkfZ4Yop1S0r40l6Y9v1RYAbczVluTc+qblsWj8"
        "yGiH4K6MtRB/K3WkR8YVjz/pxzqNyZM99otrO0fRIvi7Z1xIc2ZGlVr0pihOqi+5l8Hw790n"
        "xytvV+/5QHCM/ERWg0614P/MAAQQBf/aAAgBAQAGPwIMUxms7rM3GT1amiEaKLQhxBIbttRU"
        "TbnhwFq6wqiUfJMmh+RBbUuRQKlO/vNIHDRaeOH2YNVkUPGYklwMFc9lobB6Guc2yiT5IVLC"
        "xGyRM+LksHY1OLnNHOTdsIJtZi1UdEE8YpoSBiOA6a1IuHN+v8NdMmZvpQd2tLYN0RHl0SS8"
        "Ef24FWZDnqPESwjwi+gjtBRx8wHzlGHpz7RPQ1tavqSlxNmsVSLqpk0jon7yQvNjy44qadt6"
        "Kp1csAkzbn54R7xI/8wABBAF/9oACAEBAAE/IZ4LhnRqxqhvdctRWYiRHitfGZDw8ZvMLxxQ"
        "b8wbSQT7Sn7vky40GjT5PtA4PjfWvlsof/jj/O8U01zF/wC8ZPYtzvtTdhSykErNd6fdQUDf"
        "KIB+wotLEO3uR6fyzjvGgRbYF44ePvo+SrmpFUb2bqzZbbaeEbx+ccI2w0gdzg00qvwqJ5is"
        "JkGQYTSBOsrRcOVKGvQUmntoxnj976YEmEJC83jICh11jfwYky1NDP5p6MjfVf3skwEGaR6H"
        "lgAg6OlnaCYhnaMvoP8AFoaHZ6gN+yPNjYaRBSpGKh3UllmI0rFi4/hbUZlFu0o62io06rVE"
        "3FrmqjCOIUjOmj+R0iBDj/7w/9oADAMBAAIAAwAAABAA7TR5DvS3s2YpceD/zAAEEQX/2gAI"
        "AQMBAT8QDIEp7xGnQAAVH8fntr5S8Aco2/5ZlOe4OTM1I0Hq/wCR1/O8ElmV1ll5vpVC/P7Y"
        "H3+p86XI090jU26hK9oT0QbtXkehZpRSD6zR80e4D+pd4P/MAAQRBf/aAAgBAgEBPxDN4oGE"
        "TPWF+uIm3xSpIt5nt4ow5qM19NeBfreZxDiwxLNdQgwtzdAt2tnw0rvfbotkVTwizrfXj2FU"
        "psvkS05zhYWO1HA//Z+NeZtKpuWEIJesSbbzLI6xLvZNOUa6Qf3wIPGgkLxLIwFcXTZSGDvp"
        "PH3pfbvmu+5ibZYu7J4/NdHYzCqoqsHcEDTDjmD2TVRG+0wUlf5eKHOxLoD/zAAEEAX/2gAI"
        "AQEAAT8Q2TocHitRC4lAwiFe4wzFEuU6QtO19benflCFHufN7mLA1QAqR/yN0BYruubd4d+d"
        "BX4xSleO+ppVyhMcvHkRKhrDcK1aG0KQDC/Z0KUaIxdF3T6eG66XPtMdZ93C9L9IOwi+Z2Dj"
        "Yec7OmYNiZM7g6C3XDjtUe63McG0+PQ5L+niE8EriHGyHXbPq7RmWoHqJ+65Oes2jqSv5qOX"
        "MFAv7e3qfnSHLisKykCRNxiaAyzEiEDwGTmvYG9HZwE9CLSYN8Ofi7ln/Yi8QJBT7X1g2QIU"
        "Io46+rT1/vbgCvK/eyzrjIL0l1iCNjDjnOoLilsFfoPdGuPsHiFvd2+NgXfI1XkJGUK3EZNW"
        "onb/ACbDW3AaBPaNA04SNAYoHzuV/M+IcYbejsjfxdOL0JqpYhKsIY0JzFHz9Vx3opA9DrbP"
        "4mQ+F245yNBEjXMMvucQhC4UT8FgW2cmCaD6FZEFVD+4QxkqN7K1TNo5QrKhnMFY7BV9mCI6"
        "G9XpWRqYbPYUpKg6qP61Tpmjlt7s62g0754KJSF4opyCwLhGe2wESmDOD2E22EEau1uvYiTL"
        "3C3Qbg32esrGNqC1t+uk6IvZGNX1K565roD7BDeU+vcZQdYMdqyqQAnwpgfIHYXIrhQ/5Pys"
        "09aBOlPg43/Kv8dvDza+0qG5p0PR1Q6qhCr7QPz+XrmiQc073Z5ndOfNHb6SmyWFGU5H8U8f"
        "SmVq/guft2hV/wC5FxX+8VUx7xQAuaT/2Q=="),
    "sof10_gray": (
        # progressive, grayscale, quality 90
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoM"
        "DAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/ygALCAAtAEMBAREA/8wABAAQ"
        "/9oACAEBAAAAAf8A0Ih38MUumDc7jcIIQciCInwzDeU/AVYG5iEsFXHH+iiYQbkV/8wABBAF"
        "/9oACAEBAAEFAijkQ7tw9mFNhKB3myNOci07jirfcy4uYmw9vTDvYqR675mxq6zH377Ulyl1"
        "NbxduqHYE2WlcvKEtHZZfTpiR3EG/wCRBawEEB1cbAu+IPExdLJeCbbPD9++ycx9+bvtpPTF"
        "4Nefjmc4v4hQk6xJaTdv5YqA1PJs/wAKFo/kyyD/zAAEEAX/2gAIAQEABj8CXWPmo1VYtms5"
        "WBuRr9hJTLJgJHNhKACFfBk4dkRbWUJGsDbJ0+iKHLfE8rbKTfnM808uWpr0rbYdMD0rvJDv"
        "oCDfoRQRRKrrr9bVGNcl8ypKfAUvlTg0S/DOELc7hzI3XZJ02uGfNLzyT8YFI7Nv6eu/uUof"
        "Jjorfq39hR4sEJRtLi207ux4sRFN45GxlYspl6LBUo+lDvjn3jmcvtZVm/aDMZdRLxXPAV4G"
        "5NmxkHsckh4+JqLbKf4TcP/MAAQQBf/aAAgBAQABPyEPJHldhVt0yegRimbj9Q1bisRKvXWR"
        "ci8RWe1dnkfUZpbstSEfG6FuwUwKSiPAWUF+oAKFEOUbToYsqfPTKiN79nYx1nwNTBNcStoz"
        "5e4tAdNyxHoX/PinpHiRwO+Wwa9fF7XdnLv0tyiJjTPyIZNBpeqcjM46QpAFsRBO1xjXomvB"
        "MLLOdhJVxBvlzCS8YWQ0YfBJw1/P+lneQEl1TTXKRWdsdfDBcp193KSL5nyMWVrHAy9rbIam"
        "/NjgMXPqsUDkfgY24lsH83cQ1rfXSif2dLT8TyK+LSDVOLR/f/dizV3Ex8SytFPc4FQ11IEu"
        "Os5nBRkC/wAOMbZXdM3OCDja/wDkimLrnL7JRl/ePEU/1Fx9xxSlEGMDueHW3mpNM5g0jBUh"
        "Gd6DnSxku0SHLV1Txkp4w0EkwKH2eP/aAAgBAQAAABA3VHsSRDAk/8wABBAF/9oACAEBAAE/"
        "EK8999AJl3Xy9cviRP2dg8j/AFlnBlHkVxTvIxjHdoT29HUxcwu1hrc7X4kZF76Rh1uh8dW6"
        "yq33Ii/abN1XZdzreg/0o0IFxhEXCoRsH0i3UhlFkEWpMz/eqI1DD0hvypysxZLBP7ecLO2X"
        "za8rIWyzgft2ddFAUg8ENzo6CbbZ+085XPYKy1bEural924pMxPXfSAq2o0hE7hHus3Qy+LX"
        "Loy0GB/2+zwNjUXE6fS7MPAQ2IijcERWQou6DX95ubBFvqcDbAavyJ7oZbkBwrjWluL50YCC"
        "3cH6hIIQxwl+h4+r86cYnrWvOwWz9bylMISXs17P4BwpQ7vr8ft9Xc1QWM22hVV2bd4Se9gM"
        "704gFc/Eo0v4763Raq+yewnLDurbMVOoz9v+AwW6r0AwUmai6O9t6Wk2SA/vTy8Cby+JDx37"
        "A1zNlAJs8hOQF6/0NBXTEmFziqmAabDSYHHJT1p7+cClCnNJXYs5/asiHQs7TJpOs28PeoYi"
        "dkeEo/ezJbyeNw2F3X9pW61I5fWtQ1sTvDrDCA57bi0l0MUBZmwQVD3R10gtr1uJwCpZpBbs"
        "raFDsS3cWZ0/cbnuYTrqUzuvoQlK44EbbrgluWLUmYzQvaY/hnqQLuUDtqw3aKIPwlJluh1N"
        "QlfaG9F1zTxmpR7ViEPkLeftbYPpgoEABw8ScsKfo1TjWHwrHnu1xjXfAbgKIsZOYlQ9olg1"
        "wwQivh81su83TAuaN/1Is6NeXGV2+DMQaCZkd+IyGYMs8WQVjZXnAr2QnCd8Ff2A/9k="),
    "sof10_420_restart": (
        # progressive, YCbCr 4:2:0, quality 85, a restart every MCU row (restart_in_rows = 1)
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAUDBAQEAwUEBAQFBQUGBwwIBwcHBw8LCwkMEQ8S"
        "EhEPERETFhwXExQaFRERGCEYGh0dHx8fExciJCIeJBweHx7/2wBDAQUFBQcGBw4ICA4eFBEU"
        "Hh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh4eHh7/ygAR"
        "CAAtAEMDASIAAhEBAxEB/8wABgAQARD/3QAEAAX/2gAMAwEAAhADEAAAAf8AspbLUHKflfX1"
        "0+sJczELtsUzN3CAKLqIUnVDwDCYk4D/0P59T0xIk092peOZOBwfS2QxDorL646OQzfs9Txr"
        "Blv6+P/R9rc7ez/9gJwBQyK6gWWAHnjaEFAAhfxpkepHIjpusDn+OED/zAAEEAX/3QAEAAn/"
        "2gAIAQEAAQUCGBb/AMcPZrP2+mPNGXakIfTb/9Aa6OFnw1W8/wAjXRyqVXad7MFJY//RGugY"
        "MLmr5VZuIhMwHcVGWweg/9IVU9g/b6fJ/QNqrdKrf1ZVgGyqgP/TFU3KMQ5DycwyA+ow4WtD"
        "y+k6VgEkNr30lVHEX3m9K9D/1B5vsHl8cDtBytG/rbbzfqkQTONH/8wABBEF/90ABAAF/9oA"
        "CAEDAQE/ARVOC8JXxiEyieo0jxDDNSaMoPsmgP/QFU3ka8oRVBA97yPrnU5ZQ3skJP/RFVN3"
        "C4Ff4QID7gmMfzxBSg9P4geHKLjN2SM6xm3/zAAEEQX/2gAIAQIBAT8BFakGKjAFIKz9OsHU"
        "zoTmHUDB6j3Fx04wbtsPxm++6GjMS9PKO2mFaED/0BVqoSGxFcFu1gNnHYHVffy53tk1KZ2S"
        "seLs39znLIiZpoaj5RFe2uRCl1iR80tAovs7TmD/0RgTyCMjHdKnEIUgFDdlb39A+lhoenzd"
        "CugY65ylBVlXbOwDjmhQPgOm4TLnwPBA/8wABBAF/90ABAAJ/9oACAEBAAY/AmfMWO2Tp43p"
        "/npK/9BetOGrBExTnlqvTf11S0Eh44D/0Xlqsj1OYuoXHutJetxnMoOQ0P/S9xUE/pXXjp15"
        "KpQLyEtXvbTBW//TX6m7O/C42nO80CEBzAl4GiHOpFAdbusPR8ovmG8dVvMzNS48vAL/AGso"
        "VID/1PHrrV2g13zQlQMG+Gmut4QXeXWA/8wABBAF/9oACAEBAAE/IdtW4xonHiwT/rxJgPEI"
        "ReWEfSqBHNW7Hauo6rC8NlrC/9AnjM0qfsyikZE+OYyuW3HnPHlDnPDp1oBD6GKlaKHKSo2o"
        "/9HApQ5cKoWe0zKVyZPsRK+0JsML9e/Dzxgzkk6SWpj/0m6w03vx+gi1Svkm/wAPdastak39"
        "EgBRTDfCEJHFQTMAs/WjqQv/0705PAR42o7SI0bt1IboqvYXIfariOIkTNF97JS606sOOdza"
        "naYBEbz/1NRrli2FZV3ezJ1pVCy8WJ+wxek+3sMW6hCjaE1eC+/QsUht5t2TOP/dAAQABf/a"
        "AAwDAQACAAMAAAAQgFYCKP/Q3wXP1v/RoNXcMP/MAAQRBf/aAAgBAwEBPxBmpe4C/c58/wA/"
        "V3EtlP7PiB1R4P/QO0cTOHTNLrIbD6IAZ6tP0X3QvAP/0cqBF2a1Pi0PlQhu5CLKuZX/zAAE"
        "EQX/2gAIAQIBAT8QI3mO3Iov2oEps/mzh5m6i/jPVoNgU48D3LQ37x6bHrjo57qhANgg/9At"
        "7xG7wPkSwJ3P1Bv6yciFSNEFOAYExuuH+4ei+UIgO3h+JCli5MecpWjlfkSMG56tjbDywP/R"
        "8eIGnaI/2/dtq4f5KrDvsl2NB0fVoYPnD4oet+sywwTWAZbjyxewno7mYyjNe3bO8VPhgHqK"
        "0O1sSQ05YP/MAAQQBf/dAAQACf/aAAgBAQABPxCcWC92iOuMIrJuOnI5hDIRmyrBahGzvYCb"
        "MRB/IGi+H8cD0SA64qgUoCzB3srValbSbQ+24Bf5zlqUjS/z1xfBUQUIJZ1oZb5jISBidsdb"
        "84kTuP/QDM6Tf33LsyD6LOCnrslNnAEutKJ/8znO5cNccQP2Rz+5eNzlwbQAS4jnlNX5gND5"
        "tTTRdPXI8dBfuzF01yapPqRixKklMAopfBJJAsxe612/640gk228/9H/APJlI8wtb+zj9Udb"
        "+BZ80q+3T5Lh4nHi1zCciLPKYyUIuz3vSyx1/dsw4O71aui5kdSx7C9LOvRFpNYj+nyQIvKx"
        "qVFd6simpglf61LTAyYAgAdaS7adYzUbRID/0t3fmltBPC9qt6AnM2hqD5EI5gyVH8hOBn8B"
        "9c4aSP8A1PRFRkScnSMrDKbRZpfp+rZyU96Yvgqc2ZWL3E2H3H5CFzHjbg7T8xTJLiAYmySu"
        "C95xOX3ETHKQ4qt4/9OiPT2qoQVoyMDzu6MiabwvOlhchJZh7fHmo4REa12Loz2G2iTb4idB"
        "7IAgrL3PGf6KHHhtqqaZ1i8T0PtBvy2oy0+VOLnax/8AoP/U8+sIrpaAMww4kU8VMXbcKKrc"
        "dkjFQDLDPTuZWQg2/lqTqGNHPeMF1WxZdAgXdHkUzbED0g1EaIjPMgoyQ4bJGxPf89Z/u8CJ"
        "odmmv//Z"),
    "sof9_420_dac": (
        # sequential, YCbCr 4:2:0, quality 90, arith_dc_L = 2, arith_dc_U = 6, arith_ac_K = 12 on every table, a restart every 3 MCUs (restart_interval = 3)
        "/9j/4AAQSkZJRgABAQAAAQABAAD/2wBDAAMCAgMCAgMDAwMEAwMEBQgFBQQEBQoHBwYIDAoM"
        "DAsKCwsNDhIQDQ4RDgsLEBYQERMUFRUVDA8XGBYUGBIUFRT/2wBDAQMEBAUEBQkFBQkUDQsN"
        "FBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBQUFBT/yQAR"
        "CAAtAEMDASIAAhEBAxEB/8wACgBiEAwBYhEM/90ABAAD/9oADAMBAAIRAxEAPwD/AOcfTzeW"
        "jFOnn1FRJdaHBqnBReNuIDm2IF8Pe/0dXdhoLz+75a/cpZyuY48XiuDF3/8ABd4SxxQFrXMe"
        "U8A8wVOAmOSKo4oRWMvTsgz82eYvvOvueBnbt1VC+7tDifbHw5gSB7qMdSC8whBzjPw38i1V"
        "YDIVFc41MirIunHgGWuMZDlPotRkI5fLcfBXYhcnatlehk8CPGuQgzTYpSuJk3zsXc7ZRvZ8"
        "pmUJPTCVoENzDQeu1XRyZua5u2UMiSV242CYJxYzqADyG1DvjELSqJ+2uUzlvOblRchWCxd2"
        "aCf0GGIkpe2TUtEMSESnIF/Ec5ZZemUn26Zo6tfJgzn5DzTXhkD2r+aST61wxUrIuAMuVwRi"
        "wGT9I0Sl2+Q8IiGV0J7UHsCE3cNuZT/ubzwLK5WAlF2qk0HN56S4auoNLeqSwSGwYPnV0PYp"
        "czMtwzy6Mxr1yzYA1nwn92Ttj2GTZ5s3AC5s3WHzAGM77TAwJITWILXqiassQGBkgVD/AOni"
        "T/rzrHFzftFA/9D/AMk5bf7Otl4xkzpbUdHjM64OeJQGkd5kwdmI0v8AZl6xK2R1PsUIdIFO"
        "Wpkg2rGCvagHlpiDQWNXTZr7p31TK+mwdZeMn/rcsGANWNG4Wfpch6cw9EuCsrOd8jEB+iFc"
        "8TF4R86dkzizSoQRbkOgrN0kqmeZ6ED4ULQLKjGQkSALT3rjadGZd79mfR6nVxwjnOtkVR3S"
        "CN1bCrm1W1jB24l3QIUOm2ImKo0OAo7aiW46SxZ1ebzVysvmQxWd1ubRLpx0c0JfN5zlPhS+"
        "cFGAWToKlKu/ao6y5mquldgr0NZTFRQ7R/KHFMDzrv69bvuLcciuerXqCVr4AfsZj2uy4EYT"
        "sIB3jOKMquiiZN0ZMbBraBl2WbvXWZBXDE5DoKrAvLAje5Ba3Mn8cF1KthdY23xMk+iJqJuy"
        "L6SVflAvVl0VYLnA1aUKfg40P7pMb7F/AZ26sX7SeuMFCaZ95KcZ0ShV5bsUuucPv/eKdAU0"
        "LlfGbGj/0dJcBxqaPVcpus8gTN/GpAbhGjWmnycNJPIo+0pZoWXDNYQkX94GUtDdSvu7j4Ay"
        "CZ2w5esGmWJPsDZLL+Zq1zeyrYz/AJlzXZXJOiQNL+fvUbdSoUZc09+B1NaB/lPeLiZavqjc"
        "HzFDf0kj0HnQ4Hc2brnzADiglWfd1MDr+AqL0c3Bb+rswz0Q2ybjNchNDo/2vcI+un8BupqA"
        "9tDLitPdOp6h/jXpFRApAej2qIW25hey8xRoqIfroLTd61wXczZuZj19D4ldEEHOXzcYU9ft"
        "3be5C277tUacLw+Yntx/D23QweBB9yxmWvkYfaxrhneYlRDm+hlfJzYM8mhzUvMVLAYaHlog"
        "1Kks35JAQUYs65wa97yL8wcv2PnOmfwsMCtIucSsNl667jAznHrXyErTkc3lvKSlJkbWCGiM"
        "9wMAktreIJvPjxJIAduKkNWUnhZjvfwDqCTRfzGeYQXRQQIF71opUje24FPaCqNXXRhrj4Ff"
        "sgKt/DYbVkfoUNqD6fpOFX8jCZlJwYx8lSsBV1fM0v7CHwsNXsRcNlHNHP8AUR7rhEG2zYXD"
        "A5jEDm9IaYCmCzPLCU2bWIRVx6/LFph5d1XtNhnkeUD/0tGiznoxBMmpm4SCoKtPRA9D0Hut"
        "X0emonF5X9piMFp32Dmzi34QW75VGgN3Xwub6R3yJ4k9X1v7VVcKBalamUoXTkL9cesAMlMk"
        "iIUPORD3c7GgP+WR0IE2leqvOIKBnKXiGCHcoAYBPUYtguOAWU337dBlrsFfCDKu/Tmu0RPC"
        "pskLOCLaphxnnOR7+PlgzogPWIif0yeQqDxBqEKxs/Ol+UIjrS08J2VLKi3FS83hRHFC5yy+"
        "qo87I5ggkN4qClEG9qO7aXwhJ66FwTgMtwToKYBBibwc6X4HaNrnMA8S9ncfsivnoYzIlskh"
        "JwK4N65e4QvknDvZ37SJqBdwRs+TZqsEu0hoV1k3hsRfUokfbGPljDQJZcosNWB62Ad6eNwS"
        "XkfENaW4BpHaLau1TA/LbzSLzfDW5DgStqoZQ6ZXwgjMen85amVltmgi3UsP4Yv458AyQAfo"
        "sO3eQGWtDojxLwZkFz3+tdKP0LFEAAKNDwBaMualwMLA/9PSusPBq/I2IuUgE++e/kaHTde1"
        "KD3Ag23jhqgNX5YFhzi3ofpkUs2s+dDS4roJMLPghlDir77oCCxLei7sWmPQKQ8owTGkybNK"
        "SHa7EN6dfvDZj6VUbYkJ5MfhjtGfOhZ6EoWpOwg3eRZgOd/5cZsuAkVofFPm7rLamzlnKxOc"
        "uPusX5iWVF05pJzwfIHPC+MEapP73UeC02zjZzF6N0lKwRv0DfsTh+/7TDbkCdneCgoOvPQ0"
        "k8uwEJdszNI1fQtzf213gA/NkPLVtIufV9r8yGcXJj7kS7o4hqOg2klXnL8gSXZrqhTaY2R7"
        "bJC8xb3A6Qs8PN8NOCzRC9DYHUl0ALw1/K5XoxJFuM3cra8Ft70DrtCECxICNmPR0GWASjWp"
        "+/BV0Y0tSb5DzgOsEkFS2+YpnIvgakZNNB/cyUyCkDnRjLI7AiVxscoG/wBjOxdeTota04rR"
        "uEWkvcQR7Zyh14eUC/Hy3o62LyHB1cGnIjyAqrcDSdf0MPqmcayoKrzYZxDytU6l8kkntZdK"
        "G/RFxiuzeS/f994Lec4lIAfuey5r4P/Z"),
}

PIXEL_SHA256 = {
    "sof9_420": "3cbef765ca9cbe164d3f2e2263d3471c5c4c9d7087c01c4e61b0c04c79dcc3db",
    "sof9_gray": "e52f98285f9c9e569b6cd86ef3fb38d4f75e8238c4ffa4d08a2239a57ce703fe",
    "sof10_420": "3cbef765ca9cbe164d3f2e2263d3471c5c4c9d7087c01c4e61b0c04c79dcc3db",
    "sof10_gray": "e52f98285f9c9e569b6cd86ef3fb38d4f75e8238c4ffa4d08a2239a57ce703fe",
    "sof10_420_restart":
        "a449f93aafc708451431b4f6c5797a620a08dfc253944b221482ff1ce1db2c1a",
    "sof9_420_dac":
        "3cbef765ca9cbe164d3f2e2263d3471c5c4c9d7087c01c4e61b0c04c79dcc3db",
}
SHAPE = (45, 67, 3)


def arith_jpegs() -> dict:
    """``{name: JPEG bytes}`` of every carried file."""
    return {name: base64.b64decode("".join(parts))
            for name, parts in ((n, (s,) if isinstance(s, str) else s)
                                for n, s in SOURCES.items())}


def strip_dac(data: bytes) -> bytes:
    """``data`` without the DAC segments (0xFFCC) in front of its first
    scan, which are all a sequential file has, so that a decoder takes
    libjpeg's defaults in their place."""
    out, i = bytearray(data[:2]), 2
    while i + 4 <= len(data) and data[i] == 0xFF and data[i + 1] != 0xDA:
        n = 2 + int.from_bytes(data[i + 2:i + 4], "big")
        if data[i + 1] != 0xCC:
            out += data[i:i + n]
        i += n
    return bytes(out + data[i:])
