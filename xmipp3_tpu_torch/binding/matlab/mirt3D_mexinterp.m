function output = mirt3D_mexinterp(input_image, XI, YI, ZI)
%MIRT3D_MEXINTERP fast trilinear interpolation of a 3D (or stacked 4D)
%image at MATLAB 1-based coordinates XI, YI, ZI; NaN outside the grid —
%the interp3(...,'linear',NaN) contract of the reference MEX.
out = xmipp_matlab_bridge('mirt3D_mexinterp', struct( ...
    'input_image', input_image, 'XI', XI, 'YI', YI, 'ZI', ZI));
output = out.output_image;
end
