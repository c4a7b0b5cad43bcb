/* The port's .dat codec: rows of "%g" joined by tabs, one newline per row.
 *
 * A plain C interface (no CPython API), built at first use with the host
 * C compiler and loaded with ctypes (mdqtplasmasims_torch/_build.py):
 *
 *   size_t format_rows(const double *x, size_t nrow, size_t ncol,
 *                      char *out, size_t cap)
 *
 * writes the nrow x ncol C-ordered table ``x`` into ``out`` and returns
 * the number of bytes written (no terminating NUL), or (size_t)-1 when
 * ``cap`` is too small.  A value takes at most 13 characters under "%g"
 * ("-1.23457e+308"), so ``cap >= nrow * max(ncol, 1) * 14`` always
 * suffices.  A row of zero columns is a bare newline.
 *
 * The bytes equal Python's ``"%g" % v`` for every double.  Python and
 * glibc's printf both round correctly (an exact tie to even) and write
 * "inf", "-inf" and "-0" alike; printf writes a NaN with its sign bit set
 * as "-nan" where Python writes "nan", so every NaN is written as "nan".
 *
 * Zeros (most of a velocity distribution's tails) and NaNs are written
 * directly.  Most other values take a short path (``fast_g``): six
 * significant digits m from one correctly rounded product or quotient
 * y = |v| * 10^(5-e) with an exact power of ten (|5-e| <= 22).  y is
 * within half an ulp (< 6e-11 below 1e6) of the exact value, so rounding
 * y to the nearest integer gives the correctly rounded m unless y lies
 * within 1e-9 of a half; those values, and exponents outside [-17, 27],
 * go through snprintf("%g").
 * ``format_rows_printf`` (same arguments) formats every value through
 * snprintf: the short path's reference, which tests hold it to on
 * millions of values.
 */

#include <math.h>
#include <stddef.h>
#include <stdio.h>
#include <string.h>

#define MAX_FIELD 13

static const double POW10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

/* |v| scaled to six digits before the point at decimal exponent e */
static int scaled(double a, int e, double *y) {
    int k = 5 - e;
    if (k > 22 || k < -22) return 0;
    *y = k >= 0 ? a * POW10[k] : a / POW10[-k];
    return 1;
}

/* "%g" of a finite nonzero v into f; returns its length, or 0 when the
 * value needs snprintf */
static int fast_g(double v, char *f) {
    double a = fabs(v), y;
    int e = (int)floor(log10(a));
    if (!scaled(a, e, &y)) return 0;
    if (y < 1e5) {                     /* log10 one too high */
        e -= 1;
        if (!scaled(a, e, &y)) return 0;
    } else if (y >= 1e6) {             /* one too low */
        e += 1;
        if (!scaled(a, e, &y)) return 0;
    }
    if (y < 1e5 - 1 || y >= 1e6) return 0;
    double fl = floor(y);
    if (fabs(y - fl - 0.5) < 1e-9) return 0;     /* near a tie */
    long m = (long)fl + (y - fl > 0.5);
    if (m >= 1000000) {                /* 999999.5.. rounds up a decade */
        m /= 10;
        e += 1;
    }
    if (m < 100000) return 0;
    char d[6];
    for (int i = 5; i >= 0; i--) {
        d[i] = (char)('0' + m % 10);
        m /= 10;
    }
    int nd = 6;                        /* significant digits kept */
    while (nd > 1 && d[nd - 1] == '0') nd--;
    int n = 0;
    if (v < 0) f[n++] = '-';
    if (e >= -4 && e < 6) {            /* fixed: 5 - e decimals */
        if (e >= 0) {
            for (int i = 0; i <= e; i++) f[n++] = i < nd ? d[i] : '0';
            if (nd > e + 1) {
                f[n++] = '.';
                for (int i = e + 1; i < nd; i++) f[n++] = d[i];
            }
        } else {
            f[n++] = '0';
            f[n++] = '.';
            for (int i = 0; i < -e - 1; i++) f[n++] = '0';
            for (int i = 0; i < nd; i++) f[n++] = d[i];
        }
    } else {                           /* exponent form */
        f[n++] = d[0];
        if (nd > 1) {
            f[n++] = '.';
            for (int i = 1; i < nd; i++) f[n++] = d[i];
        }
        f[n++] = 'e';
        f[n++] = e < 0 ? '-' : '+';
        int x = e < 0 ? -e : e;
        if (x >= 100) f[n++] = (char)('0' + x / 100);
        f[n++] = (char)('0' + x / 10 % 10);
        f[n++] = (char)('0' + x % 10);
    }
    return n;
}

/* "%g" of any double, as Python writes it */
static int format_g(double v, char *f, size_t size) {
    if (isnan(v)) {
        memcpy(f, "nan", 3);
        return 3;
    }
    if (v == 0.0) {                    /* the KDE tails: most of a file */
        if (signbit(v)) {
            memcpy(f, "-0", 2);
            return 2;
        }
        f[0] = '0';
        return 1;
    }
    if (isfinite(v)) {
        int n = fast_g(v, f);
        if (n) return n;
    }
    return snprintf(f, size, "%g", v);
}

size_t format_rows(const double *x, size_t nrow, size_t ncol, char *out,
                   size_t cap) {
    size_t pos = 0;
    char field[32];
    for (size_t i = 0; i < nrow; i++) {
        if (ncol == 0) {
            if (pos + 1 > cap) return (size_t)-1;
            out[pos++] = '\n';
            continue;
        }
        for (size_t j = 0; j < ncol; j++) {
            int len = format_g(x[i * ncol + j], field, sizeof field);
            if (len < 0 || len > MAX_FIELD) return (size_t)-1;
            if (pos + (size_t)len + 1 > cap) return (size_t)-1;
            memcpy(out + pos, field, (size_t)len);
            pos += (size_t)len;
            out[pos++] = (j + 1 < ncol) ? '\t' : '\n';
        }
    }
    return pos;
}

/* snprintf("%g") alone, NaN as "nan": the short path's reference */
size_t format_rows_printf(const double *x, size_t nrow, size_t ncol,
                          char *out, size_t cap) {
    size_t pos = 0;
    char field[32];
    for (size_t i = 0; i < nrow; i++) {
        if (ncol == 0) {
            if (pos + 1 > cap) return (size_t)-1;
            out[pos++] = '\n';
            continue;
        }
        for (size_t j = 0; j < ncol; j++) {
            double v = x[i * ncol + j];
            int len = isnan(v) ? (memcpy(field, "nan", 3), 3)
                               : snprintf(field, sizeof field, "%g", v);
            if (len < 0 || len > MAX_FIELD) return (size_t)-1;
            if (pos + (size_t)len + 1 > cap) return (size_t)-1;
            memcpy(out + pos, field, (size_t)len);
            pos += (size_t)len;
            out[pos++] = (j + 1 < ncol) ? '\t' : '\n';
        }
    }
    return pos;
}
